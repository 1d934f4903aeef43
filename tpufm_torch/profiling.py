"""Profiling helpers: a device trace of a block, timed passes, and the
derived rates of a search pass.

Counterpart of tpufm/utils/profiling.py: ``trace`` (:18) over
``torch.profiler`` in place of ``jax.profiler``, writing a Chrome trace;
``timed`` (:30) over ``timer.timed_device_passes``, the port's one timing
code path; ``search_stats`` (:48) with the same fields. Its default memory
rate is the one the port's bounds use, 3.35e12 B/s: the HBM3 of an NVIDIA
H100 80GB (SXM), as NVIDIA's data sheet gives it, at the card's full 700 W
power limit. tpufm's default, 8.1e11, is a TPU's.
"""

from __future__ import annotations

import contextlib
import os

from tpufm_torch.timer import timed_device_passes

#: bytes/s of one NVIDIA H100 80GB HBM3 (data sheet, SXM part, 700 W)
H100_HBM_BYTES_PER_S = 3.35e12


@contextlib.contextmanager
def trace(out_dir: str | None = None):
    """Profile the block's host and CUDA activity with ``torch.profiler``;
    yields the profiler (``events()``, ``key_averages()``) and, where
    ``out_dir`` is given, writes its Chrome trace there as
    ``trace.json`` (open it in chrome://tracing or Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield prof
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))


def timed(fn, *args, iterations: int = 5, warmup: int = 1):
    """``fn(*args)`` after ``warmup`` untimed calls, timed over
    ``iterations`` calls, each ending at a device barrier on its result
    (``timer.timed_device_passes``). Returns (mean seconds a call, the last
    call's output)."""
    out = []

    def call():
        out[:] = [fn(*args)]
        return out[0]

    mean, _, _ = timed_device_passes(call, iterations, warmup)
    return mean, out[0]


def search_stats(seconds_per_pass: float, num_reads: int, read_len: int, k: int, entry_bytes: int,
                 hbm_bw: float = H100_HBM_BYTES_PER_S) -> dict:
    """Derived metrics of one search pass: reads/s, k-step rounds/s, row
    gathers/s (two ends a round), the gathered bytes/s, and their share of
    the memory rate ``hbm_bw`` (for ``entry_bytes``-byte rows)."""
    rounds = read_len // k
    gathers = 2 * num_reads * rounds
    gathered_bytes = gathers * entry_bytes
    return {
        "reads_per_s": num_reads / seconds_per_pass,
        "rounds_per_s": num_reads * rounds / seconds_per_pass,
        "gathers_per_s": gathers / seconds_per_pass,
        "gathered_bytes_per_s": gathered_bytes / seconds_per_pass,
        "fraction_of_hbm_sol": gathered_bytes / seconds_per_pass / hbm_bw,
    }
