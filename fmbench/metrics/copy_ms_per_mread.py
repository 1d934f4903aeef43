"""Device time of the host-to-device and device-to-host copies per million reads."""

from fmbench.derive import copy_ms_per_mread as read
