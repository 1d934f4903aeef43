"""Reads completed in the window over its seconds, host memory to host memory,
in a cell whose pace the host's copies and wave loop set."""

from fmbench.derive import rate as read
