"""Kernel launches in the traced window per million reads."""

from fmbench.derive import launches_per_mread as read
