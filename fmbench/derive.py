"""The arithmetic of the metrics, over one run's record.

Each file in metrics/ names one metric and reads it from a ``Run`` with the
functions here; a reader returns None where the run has nothing to read, and
the harness then leaves the metric out of the result line.
"""

from __future__ import annotations

import dataclasses
import statistics

import numpy as np

from fmbench.trace import Trace

#: HBM3 bytes/s of one NVIDIA H100 SXM 80GB at its 700 W limit (NVIDIA's data sheet)
H100_HBM_BYTES_PER_S = 3.35e12


@dataclasses.dataclass
class Run:
    config: dict
    traffic: dict
    #: the measured window's length, seconds
    seconds: float
    #: host-to-host seconds of every batch that completed inside the window
    batch_s: np.ndarray
    setup_s: float
    index_build_s: float
    #: the device trace of the window (runs with --trace 1)
    trace: Trace | None = None
    #: reads of every batch inside the traced span (the last one included)
    traced_reads: int = 0

    @property
    def completed_reads(self) -> int:
        return len(self.batch_s) * self.traffic["batch_reads"]


def rate(run: Run) -> float | None:
    """Reads completed in the window over the window's seconds."""
    return run.completed_reads / run.seconds if len(run.batch_s) else None


def p95_ms(run: Run) -> float | None:
    """The 95th percentile of every batch's host-to-host time, in ms
    (linear between order statistics, as ``statistics.quantiles``'
    inclusive method)."""
    if len(run.batch_s) < 2:
        return None
    return statistics.quantiles(run.batch_s.tolist(), n=20, method="inclusive")[18] * 1e3


def per_mread(run: Run, value: float) -> float | None:
    """``value`` per million reads of the traced span."""
    if run.trace is None or not run.traced_reads:
        return None
    return value / (run.traced_reads / 1e6)


def copy_ms_per_mread(run: Run) -> float | None:
    return None if run.trace is None else per_mread(run, run.trace.copy_s * 1e3)


def kernel_ms_per_mread(run: Run) -> float | None:
    return None if run.trace is None or not run.trace.kernel_s else per_mread(run, run.trace.kernel_s * 1e3)


def launches_per_mread(run: Run) -> float | None:
    return None if run.trace is None or not run.trace.launches else per_mread(run, run.trace.launches)


def device_idle_pct(run: Run) -> float | None:
    """Share of the traced window in which no kernel, copy or memset ran."""
    if run.trace is None or not run.trace.busy_s:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def lf_round_bytes_per_read(config: dict, traffic: dict) -> int:
    """The least bytes the LF rounds of one read must move, whatever
    implements them. Per k-step round: the interval in and out as two
    uint32 each (8 + 8 B), the round's code (1 B), one 4-byte counter and
    one window of plane words (2k words of 4 B); (L - lut_m) // k such
    rounds, and (L - lut_m) % k rounds at k = 1 (2 plane words)."""
    k, m, length = config["k"], config["lut_m"], traffic["read_len"]
    rounds, tail = divmod(length - m, k)
    return rounds * (8 + 8 + 1 + 4 + 2 * k * 4) + tail * (8 + 8 + 1 + 4 + 2 * 4)


def lf_round_sol_pct(run: Run, kernels) -> float | None:
    """The LF rounds' least bytes over the HBM rate, as a share of the
    device time of the kernels whose names hold one of ``kernels``."""
    if run.trace is None or not run.traced_reads:
        return None
    seconds = run.trace.kernel_time(kernels)
    if not seconds:
        return None
    least = lf_round_bytes_per_read(run.config, run.traffic) * run.traced_reads / H100_HBM_BYTES_PER_S
    return 100.0 * least / seconds
