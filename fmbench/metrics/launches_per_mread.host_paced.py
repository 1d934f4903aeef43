"""Kernel launches in the traced window per million reads.
In a cell whose pace the host's copies and wave loop set."""

from fmbench.derive import launches_per_mread as read
