"""Reads completed in the window over its seconds, host memory to host memory."""

from fmbench.derive import rate as read
