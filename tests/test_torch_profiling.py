"""tpufm_torch.profiling against tpufm/utils/profiling.py: ``timed`` (one
timing path, ``timer.timed_device_passes``: the calls it makes and the last
output) and ``trace`` (a Chrome trace of the block's activity written where
asked, the program's spans in it). The spans and counters themselves:
tests/test_torch_spans.py."""

import json

import torch

from tpufm_torch import profiling


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
        with profiling.span("tpufm.test"):
            torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    events = json.loads((tmp_path / "t" / "trace.json").read_text())["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)
    assert any(e.get("name") == "tpufm.test" for e in events)
    assert any("matmul" in e.name for e in prof.events())
    with profiling.trace() as prof:
        torch.arange(10).cumsum(0)
    assert any("cumsum" in e.name for e in prof.events()) and not (tmp_path / "trace.json").exists()

