"""Share of the traced window in which the device runs no kernel, copy or memset.
In a cell whose pace the host's copies and wave loop set."""

from fmbench.derive import device_idle_pct as read
