"""Profiling helpers: a device trace of a block, the program's spans on that
trace, and timed passes.

Counterpart of tpufm/utils/profiling.py: ``trace`` (:18) over
``torch.profiler`` in place of ``jax.profiler``, writing a Chrome trace;
``timed`` (:30) over ``timer.timed_device_passes``, the port's one timing
code path. Speed-of-light shares are the benchmark's (``fmbench``'s
``lf_round_sol_pct``), read from the device trace.

``span(name)`` marks a block of the program under ``trace``: a
``record_function`` range, kept in the profiler's own buffer on the clock of
its device events and written out by its exporter. With no profiler running
it opens nothing. The engines' spans are named ``tpufm.*`` (``tpufm.search``,
``tpufm.count``, ``tpufm.wave.upload`` / ``enqueue`` / ``readback``,
``tpufm.search.*``, ``tpufm.count.*``, ``tpufm.locate.compact``), the CLI's
stages ``tpufm.cli.<stage>``; ``python -m tpufm_torch.cli --trace DIR
<command> ...`` writes them with the command's device work to
``DIR/trace.json``.
"""

from __future__ import annotations

import contextlib
import os

import torch

from tpufm_torch.timer import timed_device_passes

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function(name)`` range while a profiler runs, else one
    shared no-op context (no range is entered)."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


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
