"""tpufm_torch.profiling against tpufm/utils/profiling.py: ``search_stats``
field by field on the same arguments (the memory rate passed to both; the
port's default is the H100's 3.35e12 B/s, tpufm's a TPU's), ``timed`` (one
timing path, ``timer.timed_device_passes``: the calls it makes and the last
output) and ``trace`` (a Chrome trace of the block's activity written where
asked). The stats are floats of the same formulas and compare exactly
(tolerance 0)."""

import inspect
import json

import pytest
import torch

from tpufm.utils import profiling as jax_profiling
from tpufm_torch import profiling


@pytest.mark.parametrize("args", [(0.0296, 1 << 20, 120, 3, 400), (1.5, 1000, 151, 1, 48), (2e-3, 7, 24, 4, 1152)])
@pytest.mark.parametrize("hbm_bw", [8.1e11, 3.35e12])
def test_search_stats_matches_tpufm(args, hbm_bw):
    got = profiling.search_stats(*args, hbm_bw=hbm_bw)
    assert got == jax_profiling.search_stats(*args, hbm_bw=hbm_bw)
    assert list(got) == ["reads_per_s", "rounds_per_s", "gathers_per_s", "gathered_bytes_per_s",
                         "fraction_of_hbm_sol"]


def test_search_stats_default_rate_is_the_h100s():
    default = inspect.signature(profiling.search_stats).parameters["hbm_bw"].default
    assert default == profiling.H100_HBM_BYTES_PER_S == 3.35e12
    assert inspect.signature(jax_profiling.search_stats).parameters["hbm_bw"].default == 8.1e11
    assert profiling.search_stats(1.0, 1, 3, 3, 1)["fraction_of_hbm_sol"] == 2 / 3.35e12


def test_timed_runs_warmup_and_passes(monkeypatch):
    """``timed(fn, *args, iterations, warmup)``: warmup + iterations calls
    through ``timer.timed_device_passes``; (mean seconds, last output)."""
    calls, seen = [], []
    real = profiling.timed_device_passes

    def spy(fn, iterations, warmup):
        seen.append((iterations, warmup))
        return real(fn, iterations, warmup)

    monkeypatch.setattr(profiling, "timed_device_passes", spy)
    mean, out = profiling.timed(lambda x: calls.append(x) or torch.full((2,), len(calls)), 5, iterations=3, warmup=2)
    assert seen == [(3, 2)] and calls == [5] * 5 and mean >= 0 and torch.equal(out, torch.full((2,), 5))


def test_trace_writes_a_chrome_trace(tmp_path):
    """The block runs under torch.profiler; the profiler comes out of the
    ``with`` and, with ``out_dir``, its Chrome trace lands in
    ``out_dir/trace.json`` with the block's operations in it."""
    with profiling.trace(str(tmp_path / "t")) as prof:
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    events = json.loads((tmp_path / "t" / "trace.json").read_text())["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)
    assert any("matmul" in e.name for e in prof.events())
    with profiling.trace() as prof:
        torch.arange(10).cumsum(0)
    assert any("cumsum" in e.name for e in prof.events()) and not (tmp_path / "trace.json").exists()

