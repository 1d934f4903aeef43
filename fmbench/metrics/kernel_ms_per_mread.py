"""Device time of every kernel, copies excluded, per million reads."""

from fmbench.derive import kernel_ms_per_mread as read
