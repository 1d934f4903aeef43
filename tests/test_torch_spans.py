"""The program's spans (``tpufm_torch.profiling.span``), the CLI's
``--trace DIR`` that writes them, and ``scripts/span_split.py``, which
splits a traced benchmark window by them.

Without a profiler no ``record_function`` is entered. Under
``profiling.trace()`` a CPU ``SearchEngine`` gives each wave one upload,
one enqueue and one read-back span inside the call's span, which they cover.
The script's reduction is checked on synthetic events (host seconds, device
seconds by correlation id, the read-back's wait and staging, a span's
device mirror never a kernel) and on a whole traced CPU run of the
harness. The ``gpu`` case checks on the card that each read-back's
device-to-host copy is launched inside ``tpufm.wave.readback`` and runs on
the device within its call, after the newest wave's kernels (the wait the
script reads)."""

import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from tpufm_torch import SearchEngine, cli, profiling, timer
from tpufm_torch.engine.locate import locate_compacted
from tpufm_torch.host.index import IndexConfig, build_index
from tpufm_torch.host.seqio import decode_bases, write_reference

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("span_split", ROOT / "scripts" / "span_split.py")
span_split = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(span_split)
Ev = span_split.Ev

WAVE_STEPS = ("tpufm.wave.upload", "tpufm.wave.enqueue", "tpufm.wave.readback")


def _index(k=2, d=64, n=3000, seed=7, repeat=False):
    codes = np.random.default_rng(seed).integers(0, 4, size=n, dtype=np.uint8)
    if repeat:  # a period-4 repeat: intervals wider than two blocks, which the paired layout repairs
        codes[n // 4: 3 * n // 4] = np.tile(np.arange(4, dtype=np.uint8), n // 8)
    return codes, build_index(codes, IndexConfig(k=k, d=d), sa_method="doubling")


def _reads(codes, L, n, seed=3):
    rng = np.random.default_rng(seed)
    return np.stack([codes[s:s + L] for s in rng.integers(0, len(codes) - L, size=n)])


def _spans(prof) -> list:
    """(name, start ns, end ns) of every ``tpufm.*`` range on the host."""
    return sorted((e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                  if e.name().startswith("tpufm.") and e.device_type().name == "CPU")


def _seconds(spans, name) -> float:
    return sum(e - s for n, s, e in spans if n == name) / 1e9


def _names(spans, name) -> int:
    return sum(n == name for n, _, _ in spans)


@pytest.fixture
def no_record_function(monkeypatch):
    """Fails the test if a ``record_function`` is made."""
    def refuse(*a, **kw):
        raise AssertionError("record_function entered with no profiler running")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)


def test_span_without_a_profiler_enters_no_record_function(no_record_function):
    assert not torch.autograd._profiler_enabled()
    assert profiling.span("tpufm.a") is profiling.span("tpufm.b")
    with profiling.span("tpufm.a"), profiling.span("tpufm.b"):
        pass
    codes, index = _index()
    engine = SearchEngine(index, "cpu", lut_m=4)
    q = _reads(codes, 16, 40)
    engine.search(q, wave=16)
    engine.count(q, mismatches=1, wave=8)
    locate_compacted(lambda r: r + 1, torch.arange(6), torch.arange(6) % 2 == 0)
    with timer.Stages()("emit"):
        pass


def test_span_under_the_profiler_is_a_range_of_its_name():
    with profiling.trace() as prof:
        with profiling.span("tpufm.outer"):
            with profiling.span("tpufm.inner"):
                torch.ones(8).sum()
    (inner, i0, i1), (outer, o0, o1) = _spans(prof)
    assert (inner, outer) == ("tpufm.inner", "tpufm.outer") and o0 <= i0 <= i1 <= o1


def _traced(call):
    with profiling.trace() as prof:
        out = call()
    return out, _spans(prof)


@pytest.mark.parametrize("path", ["search", "count_mismatches1", "paired_search", "count_exact"])
def test_engine_spans_over_several_waves(path, monkeypatch):
    """Each wave one upload, one enqueue and one read-back (a CPU result
    has no wait), the paired layout's repair waves too; the fixed-length
    search's steps in each of its waves; the wave steps cover at least 95%
    of the call's span."""
    paired = path == "paired_search"
    codes, index = _index(k=2, d=64, repeat=paired)
    L, B = 24, 600
    q = _reads(codes, L, B)
    engine = SearchEngine(index, "cpu", lut_m=4, layout="paired" if paired else "fused")
    monkeypatch.setattr(SearchEngine, "REPAIR_WAVE", 64)
    if path == "count_mismatches1":
        wave, top = 40, "tpufm.count"
        out, spans = _traced(lambda: engine.count(q, mismatches=1, wave=wave))
        np.testing.assert_array_equal(out, engine.count(q, mismatches=1, wave=wave))
    elif path == "count_exact":
        wave, top = 128, "tpufm.count"
        out, spans = _traced(lambda: engine.count(q, wave=wave))
        assert _names(spans, "tpufm.search") == 1
    else:
        wave, top = 128, "tpufm.search"
        out, spans = _traced(lambda: engine.search(q, wave=wave))
        np.testing.assert_array_equal(out, engine.search(q, wave=wave))
    waves = math.ceil(B / wave)
    repaired = 0
    if paired:
        repaired = round(engine.last_repair_fraction * B)
        assert repaired > 64
        waves += math.ceil(repaired / 64)
    assert [_names(spans, n) for n in WAVE_STEPS] == [waves] * 3
    assert _names(spans, top) == 1
    # the paired round is K1's paired entry; only its repair waves take the fixed search
    fixed = waves - math.ceil(B / wave) if paired else waves
    assert [_names(spans, f"tpufm.search.{n}") for n in ("start", "codes", "rounds", "tail")] == [fixed] * 3 + [0]
    if path == "count_mismatches1":
        assert _names(spans, "tpufm.count.variants") == _names(spans, "tpufm.count.sum") == waves
    (_, t0, t1), = [s for s in spans if s[0] == top]
    assert all(t0 <= s <= e <= t1 for _, s, e in spans)
    steps = sum(_seconds(spans, n) for n in WAVE_STEPS)
    assert steps >= 0.95 * (t1 - t0) / 1e9


def test_tail_rounds_have_their_span_only_where_there_are_any():
    codes, index = _index(k=3, d=64)
    _, tail = _index(k=1, d=64)
    engine = SearchEngine(index, "cpu", lut_m=3, tail_index=tail)
    for L, tails in [(21, 0), (23, 2)]:
        _, spans = _traced(lambda: engine.search(_reads(codes, L, 50), wave=25))
        assert _names(spans, "tpufm.search.tail") == tails


def test_locate_compacted_emits_its_span():
    rows, valid = torch.arange(10), torch.arange(10) % 3 == 0
    with profiling.trace() as prof:
        pos = locate_compacted(lambda r: r * 2, rows, valid)
    assert torch.equal(pos, torch.where(valid, rows * 2, 0))
    assert [n for n, _, _ in _spans(prof)] == ["tpufm.locate.compact"]


def test_stages_add_seconds_and_a_span_of_each_stage():
    stages = timer.Stages()
    with profiling.trace() as prof:
        with stages("tables"):
            time.sleep(0.01)
        with stages("tables"):
            pass
        with stages("emit"):
            pass
    assert stages["tables"] >= 0.01 and set(stages) == {"tables", "emit"}
    spans = _spans(prof)
    assert [n for n, _, _ in spans].count("tpufm.cli.tables") == 2 and _names(spans, "tpufm.cli.emit") == 1
    assert _seconds(spans, "tpufm.cli.tables") <= stages["tables"]


@pytest.mark.parametrize("command", ["count_mismatches1_tail", "locate_fused"])
def test_cli_trace_writes_the_program_spans(command, tmp_path):
    """``--trace DIR`` writes the command's Chrome trace with the spans an
    operator reads there: Hamming counting's variants, sum and k=1 tail
    rounds; the fused locate's compaction and the CLI's stages."""
    codes = np.random.default_rng(11).integers(0, 4, size=3000, dtype=np.uint8)
    ref = tmp_path / "ref.fa"
    write_reference(ref, decode_bases(codes))
    L = 25 if command == "count_mismatches1_tail" else 24
    qry = str(tmp_path / "reads.qry")
    cli.main(["genreads", str(ref), "3000", str(L), "40", "--output", qry])
    out = tmp_path / "trace"
    if command == "count_mismatches1_tail":
        index = str(tmp_path / "ref.npz")
        cli.main(["build", str(ref), "3000", "--k", "2", "--d", "64", "--tail", "--output", index, "--device", "cpu"])
        cli.main(["--trace", str(out), "count", index, qry, str(L), "40", "--mismatches", "1", "--device", "cpu"])
        want = {"tpufm.count", "tpufm.count.variants", "tpufm.count.sum", "tpufm.search.tail", "tpufm.wave.readback"}
    else:
        cli.main(["--trace", str(out), "locate", str(ref), "3000", qry, str(L), "40", "--k", "2", "--d", "64",
                  "--fused", "--output", str(tmp_path / "reads.pos"), "--device", "cpu"])
        want = {"tpufm.cli.tables", "tpufm.cli.reads", "tpufm.locate.compact"}
    names = {e.get("name") for e in json.loads((out / "trace.json").read_text())["traceEvents"]}
    assert want <= names


class _Raw:
    """A profiler event as torch's ``_KinetoEvent`` gives it, with or
    without ``is_user_annotation`` (without: the name-only fallback)."""

    def __init__(self, name, device, start, end, corr=0, thread=1, annotation=None):
        self._v = (name, device, start, end, corr, thread)
        if annotation is not None:
            self.is_user_annotation = lambda: annotation

    def name(self):
        return self._v[0]

    def device_type(self):
        return type("D", (), {"name": self._v[1]})

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def start_thread_id(self):
        return self._v[5]


class _Prof:
    def __init__(self, raw):
        self.profiler = type("P", (), {"kineto_results": type("K", (), {"events": lambda _: raw})()})()


def _raw_window(with_spans: bool, flag: bool):
    """A window of one batch: two kernel launches and a copy, inside
    ``tpufm.*`` spans (and their device mirrors) when ``with_spans``."""
    a = (lambda v: v) if flag else (lambda v: None)
    raw = [_Raw("fmbench.window", "CPU", 0, 1000, annotation=a(True)),
           _Raw("fmbench.batch", "CPU", 10, 990, annotation=a(True)),
           _Raw("cudaLaunchKernel", "CPU", 120, 130, corr=11, annotation=a(False)),
           _Raw("cudaLaunchKernel", "CPU", 320, 330, corr=12, annotation=a(False)),
           _Raw("cudaMemcpyAsync", "CPU", 510, 800, corr=13, annotation=a(False)),
           _Raw("cudaStreamSynchronize", "CPU", 800, 820, corr=14, annotation=a(False)),
           _Raw("lf_round_pairs_kernel", "CUDA", 140, 300, corr=11, annotation=a(False)),
           _Raw("elementwise_kernel", "CUDA", 340, 400, corr=12, annotation=a(False)),
           _Raw("Memcpy DtoH (Device -> Pageable)", "CUDA", 620, 780, corr=13, annotation=a(False)),
           # an operator whose id, in its own sequence, equals the first launch's
           _Raw("aten::slice", "CPU", 850, 860, corr=11, annotation=a(False))]
    if with_spans:
        raw += [_Raw("tpufm.search", "CPU", 20, 980, annotation=a(True)),
                _Raw("tpufm.wave.enqueue", "CPU", 100, 500, annotation=a(True)),
                _Raw("tpufm.search.rounds", "CPU", 110, 200, annotation=a(True)),
                _Raw("tpufm.count.variants", "CPU", 300, 350, annotation=a(True)),
                _Raw("tpufm.wave.readback", "CPU", 500, 900, annotation=a(True)),
                _Raw("tpufm.wave.enqueue", "CUDA", 140, 400, annotation=a(True)),
                _Raw("tpufm.wave.readback", "CUDA", 620, 780, annotation=a(True))]
    return raw


def test_benchmark_trace_reads_the_same_with_spans_where_annotations_are_flagged():
    """``fmbench.trace``'s reduction, as the card's torch gives it
    (``is_user_annotation``, no activity type): the spans and their device
    mirrors change no kernel, launch or busy second."""
    from fmbench import trace

    plain, spanned = (trace.reduce(trace.from_profiler(_Prof(_raw_window(s, True)))) for s in (False, True))
    assert (spanned.kernel_s, spanned.launches, spanned.busy_s, spanned.copy_s) == \
        (plain.kernel_s, plain.launches, plain.busy_s, plain.copy_s) == (220e-9, 2, 380e-9, 160e-9)
    assert "tpufm.wave.readback" in spanned.idle_s and "cudaMemcpyAsync" in plain.idle_s


@pytest.mark.parametrize("flag", [True, False], ids=["is_user_annotation", "name_only"])
def test_split_of_a_synthetic_window(flag):
    """Host seconds a span, device seconds by the launching call's
    correlation id at any depth (an operator sharing the id does not
    launch), the read-back's wait (a blocking call's start to its copy's
    device start; a call with no copy, throughout) and staging (the copy's
    end to the call's end), the mirrors of spans never kernels, also where the
    profiler flags no annotation."""
    evs = span_split.events(_Prof(_raw_window(True, flag)))
    assert sorted(e.name for e in evs if e.kind == "kernel") == ["elementwise_kernel", "lf_round_pairs_kernel"]
    assert [e.corr for e in evs if e.kind == "copy"] == [13]
    got = span_split.split(evs)
    assert got["span_s"] == pytest.approx({
        "fmbench.window": 1000e-9, "fmbench.batch": 980e-9, "tpufm.search": 960e-9,
        "tpufm.wave.enqueue": 400e-9, "tpufm.search.rounds": 90e-9, "tpufm.count.variants": 50e-9,
        "tpufm.wave.readback": 400e-9}, abs=1e-15)
    assert got["span_n"]["tpufm.wave.enqueue"] == 1
    assert got["span_device_s"] == pytest.approx({
        "fmbench.window": 380e-9, "fmbench.batch": 380e-9, "tpufm.search": 380e-9,
        "tpufm.wave.enqueue": 220e-9, "tpufm.search.rounds": 160e-9, "tpufm.count.variants": 60e-9,
        "tpufm.wave.readback": 160e-9}, abs=1e-15)
    assert got["readback_blocked_s"] == pytest.approx(310e-9, abs=1e-15)
    assert got["readback_wait_s"] == pytest.approx((620 - 510 + 20) * 1e-9, abs=1e-15)
    assert got["readback_staging_s"] == pytest.approx((800 - 780) * 1e-9, abs=1e-15)


def test_split_clips_to_the_window():
    evs = [Ev("span", "fmbench.window", 100, 200), Ev("span", "tpufm.wave.enqueue", 50, 150),
           Ev("span", "tpufm.wave.upload", 190, 260), Ev("span", "tpufm.wave.upload", 300, 400),
           Ev("host", "cudaLaunchKernel", 60, 70, corr=5), Ev("kernel", "k", 80, 160, corr=5),
           # a launch from another thread, at a time inside the window's spans, is none of theirs
           Ev("host", "cudaLaunchKernel", 120, 125, thread=9, corr=6), Ev("kernel", "k", 130, 140, corr=6)]
    got = span_split.split(evs)
    assert got["span_s"] == pytest.approx({"fmbench.window": 100e-9, "tpufm.wave.enqueue": 50e-9,
                                           "tpufm.wave.upload": 10e-9}, abs=1e-15)
    assert got["span_n"]["tpufm.wave.upload"] == 1
    assert got["span_device_s"] == {"tpufm.wave.enqueue": pytest.approx(60e-9, abs=1e-15)}
    assert got["readback_blocked_s"] == got["readback_wait_s"] == got["readback_staging_s"] == 0


def test_readback_wait_counts_only_blocking_calls_inside_readbacks():
    """The wait: from a blocking runtime call's start inside a read-back to
    the device start of the copy it launched, clipped to the call; the
    staging from the copy's end to the call's end; an upload's copy and a
    synchronize outside any read-back do not count."""
    evs = [Ev("span", "fmbench.window", 0, 1000), Ev("span", "tpufm.wave.readback", 100, 300),
           Ev("host", "cudaMemcpyAsync", 110, 290, corr=1), Ev("copy", "Memcpy DtoH", 200, 280, corr=1),
           Ev("span", "tpufm.wave.upload", 400, 500),
           Ev("host", "cudaMemcpyAsync", 410, 490, corr=2), Ev("copy", "Memcpy HtoD", 420, 480, corr=2),
           Ev("host", "cudaStreamSynchronize", 600, 650, corr=3)]
    got = span_split.split(evs)
    assert got["span_device_s"]["tpufm.wave.readback"] == pytest.approx(80e-9, abs=1e-15)
    assert got["readback_blocked_s"] == pytest.approx(180e-9, abs=1e-15)
    assert got["readback_wait_s"] == pytest.approx((200 - 110) * 1e-9, abs=1e-15)
    assert got["readback_staging_s"] == pytest.approx((290 - 280) * 1e-9, abs=1e-15)
    # a copy the device ran before its call began (clocks apart) waits for nothing
    evs[2:4] = [Ev("host", "cudaMemcpyAsync", 110, 290, corr=1), Ev("copy", "Memcpy DtoH", 90, 300, corr=1)]
    got = span_split.split(evs)
    assert (got["readback_wait_s"], got["readback_staging_s"]) == (0, 0)


def test_readings_per_million_reads():
    spans = {"span_s": {"fmbench.batch": 2.0, "tpufm.search": 1.9, "tpufm.wave.upload": 0.5,
                        "tpufm.wave.enqueue": 0.4, "tpufm.wave.readback": 0.9},
             "span_device_s": {"tpufm.count.variants": 0.25},
             "readback_blocked_s": 0.7, "readback_wait_s": 0.6, "readback_staging_s": 0.04}
    got = span_split.readings(spans, 2_000_000, 1500)
    assert got == pytest.approx({
        "upload_ms_per_mread": 250.0, "enqueue_ms_per_mread": 200.0, "wait_ms_per_mread": 300.0,
        "readback_ms_per_mread": 150.0, "staging_ms_per_mread": 20.0, "upload_gbps": 6.0,
        "variants_device_ms_per_mread": 125.0, "wave_steps_share_of_call": 1.8 / 1.9,
        "call_share_of_batch": 0.95})
    assert span_split.readings({"span_s": {}, "span_device_s": {}}, 10, 120) == {}


#: a traced run of a tiny exact cell through the script, in an interpreter
#: without jax (the harness refuses to run where jax is loaded)
_CPU_RUN = """
import importlib.util, json, sys, time
import torch
spec = importlib.util.spec_from_file_location("span_split", sys.argv[1])
span_split = importlib.util.module_from_spec(spec)
spec.loader.exec_module(span_split)
from fmbench import registry
config = {"name": "tiny", "text_bases": 20000, "k": 3, "d": 192, "lut_m": 6, "sample_rate": 32}
traffic = {"entry": "search", "read_len": 120, "batch_reads": 256, "pool_batches": 2}
names = ["launches_per_mread", "index_build_s"]
r = span_split.traced_run(config, traffic, [{"name": n, "unit": "-"} for n in names],
                          {n: registry.metric(n) for n in names}, registry.entry("search"),
                          2**33 + 5, 0.5, torch.device("cpu"), time.perf_counter())
print(json.dumps(r))
"""


def test_traced_cpu_run_of_a_cell_splits_its_window():
    """The script over the harness on the CPU at a tiny size: the run is
    correct, the calls cover the batches, the wave steps cover the calls,
    the upload's rate is read from the reads the window sent."""
    out = subprocess.run([sys.executable, "-c", _CPU_RUN, str(ROOT / "scripts" / "span_split.py")],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    r = json.loads(out.stdout.splitlines()[-1])
    assert r["correct"] is True
    sp = r["spans"]
    assert sp["reads"] == r["batches"]["sent"] * 256
    assert sp["readings"]["upload_gbps"] == pytest.approx(
        sp["reads"] * 120 / sp["span_s"]["tpufm.wave.upload"] / 1e9)
    assert sp["span_n"]["tpufm.search"] >= r["batches"]["completed"]
    assert sp["readings"]["call_share_of_batch"] >= 0.95
    assert sp["readings"]["wave_steps_share_of_call"] >= 0.95


@pytest.mark.gpu
def test_readback_waits_for_the_newest_wave_on_card():
    """One traced ``SearchEngine.search`` of three waves on the card: each
    read-back span launches one device-to-host copy, which the device runs
    inside its call, on the profiler's one clock, after every kernel
    launched before it (the newest wave's rounds too); the script reads the
    host's wait for them, and wait, copy and staging add up to the call;
    no span is a kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the port's kernels have no CPU mode")
    codes, index = _index(k=3, d=192, n=20000)
    engine = SearchEngine(index, "cuda", lut_m=6)
    q = _reads(codes, 120, 3000)
    want = engine.search(q, wave=1024)
    with profiling.trace() as prof:
        with torch.profiler.record_function("fmbench.window"):
            got = engine.search(q, wave=1024)
    np.testing.assert_array_equal(got, want)
    evs = span_split.events(prof)
    backs = sorted((e for e in evs if e.kind == "span" and e.name == "tpufm.wave.readback"), key=lambda e: e.start)
    calls = {e.corr: e for e in evs if e.kind == "host" and e.corr}
    kernels = [e for e in evs if e.kind == "kernel" and e.corr in calls]
    dtoh = sorted((e for e in evs if e.kind == "copy" and "DtoH" in e.name), key=lambda e: calls[e.corr].start)
    assert len(backs) == len(dtoh) == 3
    for back, copy in zip(backs, dtoh):
        call = calls[copy.corr]
        assert back.start <= call.start <= call.end <= back.end
        assert call.start <= copy.start <= copy.end <= call.end
        before = [k for k in kernels if calls[k.corr].start < call.start]
        assert before and copy.start >= max(k.end for k in before)
    got = span_split.split(evs)
    assert got["readback_wait_s"] > 0
    parts = got["readback_wait_s"] + got["span_device_s"]["tpufm.wave.readback"] + got["readback_staging_s"]
    assert parts == pytest.approx(got["readback_blocked_s"], rel=1e-6)
    assert not any(e.name.startswith("tpufm.") for e in evs if e.kind == "kernel")
