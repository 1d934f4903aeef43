"""The 95th percentile of the host-to-host time of every batch of the traced
run, in a cell whose pace the host's copies and wave loop set."""

from fmbench.derive import p95_ms as read
