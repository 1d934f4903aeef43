"""Device time of every kernel, copies excluded, per million reads.
In a cell whose pace the host's copies and wave loop set."""

from fmbench.derive import kernel_ms_per_mread as read
