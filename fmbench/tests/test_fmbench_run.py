"""A whole run on the CPU at a tiny size, with the look for a chip skipped:
the result line, the check of outputs against the reference, the control,
and faults planted under the timed path that the check must catch."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from fmbench import harness, registry
from fmbench.control import control_readings

ROOT = registry.ROOT
CONFIG = {"name": "tiny", "text_bases": 20000, "k": 3, "d": 192, "lut_m": 6, "sample_rate": 32}
MIXES = {
    "exact": {"entry": "search", "read_len": 120, "batch_reads": 64, "pool_batches": 2},
    "hamming1": {"entry": "count_hamming1", "read_len": 120, "batch_reads": 12, "pool_batches": 2,
                 "substitution_rate": 0.02},
}
#: the engine method under each entry's timed path that a fault breaks
DEVICE_CALL = {"search": "search_device", "count_hamming1": "count_mismatch_device"}
SEED = 2**33 + 5
#: a cell of BENCHMARK.json
CELL = registry.benchmark()["workloads"][0]["name"]


def cpu_run(mix: str, traced=False, fault=None, seconds=0.6):
    traffic = MIXES[mix]
    names = ["reads_per_s", "batch_p95_ms", "setup_s"] if not traced else \
        ["copy_ms_per_mread", "launches_per_mread", "index_build_s", "batch_p95_ms.host_paced"]
    metrics = [{"name": n, "unit": "-"} for n in names]
    readers = {m["name"]: registry.metric(m["name"]) for m in metrics}
    return harness.run(CONFIG, traffic, metrics, readers, registry.entry(traffic["entry"]),
                       SEED, seconds, traced, torch.device("cpu"), time.perf_counter(), fault=fault)


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_a_sound_run_is_correct(mix):
    r = cpu_run(mix)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert all(c["value"] <= c["limit"] == 0 for c in r["checks"].values())
    assert set(r["metrics"]) == {"reads_per_s", "batch_p95_ms", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in r["metrics"].values())
    assert r["device"]["count"] == 1 and "memory_peak_bytes" in r["device"]
    assert r["batches"]["reads_compared"] == MIXES[mix]["batch_reads"] * MIXES[mix]["pool_batches"]
    json.dumps(r)


def test_a_traced_run_reports_per_layer_metrics_and_a_breakdown():
    r = cpu_run("exact", traced=True)
    assert r["correct"] is True
    assert {"window_s", "busy_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "index_build_s" in r["metrics"] and "batch_p95_ms.host_paced" in r["metrics"]
    assert list(r)[-1] == "checks"


def unchanged_state(monkeypatch):
    """Every LF round returns its intervals as it got them."""
    def fault(engine):
        monkeypatch.setattr("tpufm_torch.engine.search.lf_round_pairs", lambda entries, iv, *a: iv)
    return fault


def half_the_batch(monkeypatch, method):
    """Only the first half of each wave is computed; its answers stand in for the rest."""
    def fault(engine):
        orig = getattr(engine, method)

        def half(q, *a, **kw):
            out = orig(q[: max(1, q.shape[0] // 2)], *a, **kw)
            return torch.cat([out, out])[: q.shape[0]]
        monkeypatch.setattr(engine, method, half)
    return fault


def one_answer_altered(monkeypatch, method):
    """The first answer of each wave is off by one where it is produced."""
    def fault(engine):
        orig = getattr(engine, method)

        def altered(q, *a, **kw):
            out = orig(q, *a, **kw).clone()
            out[0] += 1
            return out
        monkeypatch.setattr(engine, method, altered)
    return fault


@pytest.mark.parametrize("kind", ["unchanged_state", "half_the_batch", "one_answer_altered"])
@pytest.mark.parametrize("mix", sorted(MIXES))
def test_a_fault_under_the_timed_path_is_not_correct(monkeypatch, mix, kind):
    method = DEVICE_CALL[MIXES[mix]["entry"]]
    fault = {"unchanged_state": lambda: unchanged_state(monkeypatch),
             "half_the_batch": lambda: half_the_batch(monkeypatch, method),
             "one_answer_altered": lambda: one_answer_altered(monkeypatch, method)}[kind]()
    r = cpu_run(mix, fault=fault)
    assert r["correct"] is False
    assert r["failed"] > 0


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_the_control_is_not_correct(mix):
    traffic = MIXES[mix]
    for seed in (1, 2, 3):
        wrong = control_readings(CONFIG, traffic, registry.entry(traffic["entry"]), seed, torch.device("cpu"))
        assert sum(wrong.values()) > 0


def test_banned_modules_compare_whole_top_level_names(monkeypatch):
    assert harness.banned_modules() == []
    for name in ("tpufm_torch", "tpufm_torchx", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.banned_modules() == []
    monkeypatch.setitem(sys.modules, "tpufm.engine", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert harness.banned_modules() == ["jaxlib", "tpufm"]


def test_a_run_loads_neither_jax_nor_tpufm():
    """A whole CPU run in a fresh process, then its module table."""
    code = (
        "import sys, time, torch; sys.path.insert(0, sys.argv[1]);"
        "from fmbench.tests.test_fmbench_run import cpu_run;"
        "assert all(cpu_run(mix, traced=True)['correct'] for mix in ('exact', 'hamming1'));"
        "from fmbench.harness import banned_modules; print(banned_modules())"
    )
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "fmbench/run.py", "--workload", CELL, "--seed", str(SEED),
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert f"fmbench: {CELL} needs 1 CUDA device(s); torch sees 0" in out.stderr


def test_run_without_the_program_prints_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files, a card faked present."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "fmbench", tmp_path / "fmbench", ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import runpy, sys, torch; torch.cuda.is_available = lambda: True; torch.cuda.device_count = lambda: 1;"
            f"sys.argv = ['fmbench/run.py', '--workload', '{CELL}', '--seed', '1', '--seconds', '1'];"
            "runpy.run_path('fmbench/run.py', run_name='__main__')")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=tmp_path, env=env,
                         timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "fmbench: the program is not beside the benchmark: No module named 'tpufm_torch'" in out.stderr


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in registry.benchmark()["workloads"]])
def test_a_short_run_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "fmbench/run.py", "--workload", cell, "--seed", str(SEED),
                          "--seconds", "2", "--trace", "1"], capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
    bench = registry.benchmark()
    assert set(r["metrics"]) == {m["name"] for m in registry.metrics(bench, cell, traced=True)}
