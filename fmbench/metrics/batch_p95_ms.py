"""The 95th percentile of the host-to-host time of every batch in the window."""

from fmbench.derive import p95_ms as read
