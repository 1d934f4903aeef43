"""Wall-clock timing of passes: the reference's TIME: protocol (the mean of
``iterations`` passes, reference common/searchQueries.c:78-118).

Counterparts of ``device_sync`` (tpufm/utils/timer.py:43) and
``timed_device_passes`` (:61). A pass ends at a
device barrier: ``torch.cuda.synchronize`` on every CUDA device that holds a
tensor of its result (torch returns before the card finishes). A result on
the CPU, or in host memory, is complete when it is returned and needs none.
"""

from __future__ import annotations

import contextlib
import time

import torch


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for item in x:
            yield from _tensors(item)


def device_sync(x) -> None:
    """Wait until the work producing ``x`` (a tensor, or tuples and lists
    of them; anything else, such as a host array, is taken as complete) has
    finished on every CUDA device that holds a part of it."""
    for device in {t.device for t in _tensors(x) if t.device.type == "cuda"}:
        torch.cuda.synchronize(device)


def timed_device_passes(fn, iterations: int = 5, warmup: int = 1):
    """Time ``iterations`` passes of ``fn`` after ``warmup`` untimed ones,
    each pass ending at ``device_sync`` of its result.

    Returns (mean seconds, min seconds, the list of per-pass seconds): the
    mean is the TIME: protocol's number, the list gives the median and the
    spread."""
    for _ in range(warmup):
        device_sync(fn())
    times = []
    for _ in range(iterations):
        t0 = time.perf_counter()
        device_sync(fn())
        times.append(time.perf_counter() - t0)
    return sum(times) / len(times), min(times), times


class Stages(dict):
    """Host-clock seconds of the named stages of one run: ``with
    stages("emit"): ...`` adds the block's time to its stage, and under a
    profiler marks the block as the span ``tpufm.cli.<name>``."""

    @contextlib.contextmanager
    def __call__(self, name: str):
        from tpufm_torch.profiling import span  # profiling imports this module

        t0 = time.perf_counter()
        try:
            with span(f"tpufm.cli.{name}"):
                yield
        finally:
            self[name] = self.get(name, 0.0) + time.perf_counter() - t0
