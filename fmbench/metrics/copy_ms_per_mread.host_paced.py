"""Device time of the host-to-device and device-to-host copies per million reads.
In a cell whose pace the host's copies and wave loop set."""

from fmbench.derive import copy_ms_per_mread as read
