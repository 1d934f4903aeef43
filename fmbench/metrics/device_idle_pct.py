"""Share of the traced window in which the device runs no kernel, copy or memset."""

from fmbench.derive import device_idle_pct as read
