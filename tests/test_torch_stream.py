"""Resumable search and locate: ``tpufm_torch.host.stream`` and the CLI's
``search --resume`` / ``locate --resume`` against tpufm's
(tpufm/io/stream.py, tpufm/cli.py:365-376, :1071-1093). A run killed after
some waves and run again continues after its last completed wave; a stale,
torn or foreign checkpoint (other reads, another index's k and d, another
wave) restarts from zero; a checkpoint written by tpufm is continued by the
port and the other way round, to the same bytes; ``locate --resume``
refuses what tpufm refuses. Intervals and positions compare exactly
(tolerance 0)."""

import shutil

import numpy as np
import pytest

from tpufm import cli as jax_cli
from tpufm.config import IndexConfig as JaxIndexConfig
from tpufm.engine.xla import SearchLocateEngine as JaxSearchLocate
from tpufm.engine.xla import XLAEngine
from tpufm.index.builder import build_index as jax_build_index
from tpufm.index.locate import build_locate as jax_build_locate
from tpufm.io import stream as jax_stream
from tpufm.io.fasta import write_reference
from tpufm.io.genreads import generate_reads, write_reads_fasta
from tpufm.utils.encoding import decode_bases
from tpufm_torch import SearchEngine
from tpufm_torch import cli as torch_cli
from tpufm_torch.engine.search_locate import SearchLocateEngine
from tpufm_torch.host import stream
from tpufm_torch.host.index import IndexConfig, build_index
from tpufm_torch.host.locate import build_locate, locate_hits
from tpufm_torch.host.oracle import search_oracle
from tpufm_torch.host.suffix_array import suffix_array

N, K, D, S, L, B, WAVE, HITS = 3000, 2, 64, 8, 24, 100, 32, 4


class Crashing:
    """An engine that raises after ``left`` calls of its search method and
    counts the calls it let through; every other attribute is the engine's
    (the fingerprint reads bwtsize, k and d through it)."""

    def __init__(self, engine, left, method="search"):
        self._engine, self._left, self._method, self.calls = engine, left, method, 0

    def __getattr__(self, name):
        attr = getattr(self._engine, name)
        if name != self._method:
            return attr

        def call(*args, **kwargs):
            if self._left == 0:
                raise RuntimeError("simulated crash")
            self._left -= 1
            self.calls += 1
            return attr(*args, **kwargs)
        return call


@pytest.fixture(scope="module")
def world():
    codes = np.random.default_rng(21).integers(0, 4, N, dtype=np.uint8)
    sa = suffix_array(codes)
    index = build_index(codes, IndexConfig(k=K, d=D), sa=sa)
    loc = build_locate(codes, sample_rate=S, d=D, sa=sa)
    reads = generate_reads(codes, L, B, seed=3)
    reads[::7] = np.random.default_rng(4).integers(0, 4, (len(reads[::7]), L), dtype=np.uint8)
    jax_index = jax_build_index(codes, JaxIndexConfig(k=K, d=D))
    return dict(codes=codes, index=index, loc=loc, reads=reads,
                search=SearchEngine(index, "cpu"), search_locate=SearchLocateEngine(index, loc, "cpu", max_hits=HITS),
                jax_search=XLAEngine(jax_index),
                jax_search_locate=JaxSearchLocate(jax_index, jax_build_locate(codes, sample_rate=S, d=D),
                                                  max_hits=HITS))


def _want(world, kind):
    iv = search_oracle(world["index"], world["reads"])
    return iv if kind == "search" else locate_hits(world["loc"], iv, HITS)


def _resumable(pkg, kind):
    mod = stream if pkg == "torch" else jax_stream
    return getattr(mod, f"{kind}_resumable")


def _engine(world, pkg, kind):
    name = "search" if kind == "search" else "search_locate"
    return world[name if pkg == "torch" else f"jax_{name}"]


def _method(kind):
    return "search" if kind == "search" else "search_locate"


@pytest.mark.parametrize("kind", ["search", "locate"])
@pytest.mark.parametrize("done", [1, 3])
def test_crash_and_resume(world, tmp_path, kind, done):
    out = tmp_path / "r.out"
    eng = _engine(world, "torch", kind)
    with pytest.raises(RuntimeError, match="simulated crash"):
        _resumable("torch", kind)(Crashing(eng, done, _method(kind)), world["reads"], out, wave=WAVE)
    assert (tmp_path / "r.out.partial").exists() and (tmp_path / "r.out.progress").exists()
    cont = Crashing(eng, 99, _method(kind))
    stats = {}
    got = _resumable("torch", kind)(cont, world["reads"], out, wave=WAVE, stats=stats)
    assert cont.calls == -(-B // WAVE) - done
    assert stats["search_s"] > 0
    np.testing.assert_array_equal(got, _want(world, kind))
    assert got.dtype == np.uint32 and got.flags.writeable
    assert not (tmp_path / "r.out.partial").exists() and not (tmp_path / "r.out.progress").exists()


def _checkpoint(world, tmp_path, pkg, kind, reads=None, engine=None, wave=WAVE, done=2):
    out = tmp_path / f"{pkg}.out"
    eng = engine or _engine(world, pkg, kind)
    with pytest.raises(RuntimeError):
        _resumable(pkg, kind)(Crashing(eng, done, _method(kind)), world["reads"] if reads is None else reads,
                              out, wave=wave)
    return out


@pytest.mark.parametrize("kind", ["search", "locate"])
def test_checkpoint_files_equal_tpufm(world, tmp_path, kind):
    """After the same crash, the .partial and .progress bytes are tpufm's."""
    ours = _checkpoint(world, tmp_path, "torch", kind)
    theirs = _checkpoint(world, tmp_path, "jax", kind)
    for suffix in (".partial", ".progress"):
        assert (tmp_path / f"torch.out{suffix}").read_bytes() == (tmp_path / f"jax.out{suffix}").read_bytes()
    assert ours != theirs


@pytest.mark.parametrize("kind", ["search", "locate"])
@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_checkpoint_interchange(world, tmp_path, kind, writer, reader):
    """One package crashes after two waves; the other continues the run,
    searching only the waves left, to the uninterrupted result."""
    out = _checkpoint(world, tmp_path, writer, kind)
    (tmp_path / "x.out.partial").write_bytes(out.with_suffix(".out.partial").read_bytes())
    (tmp_path / "x.out.progress").write_bytes(out.with_suffix(".out.progress").read_bytes())
    cont = Crashing(_engine(world, reader, kind), 99, _method(kind))
    got = _resumable(reader, kind)(cont, world["reads"], tmp_path / "x.out", wave=WAVE)
    assert cont.calls == -(-B // WAVE) - 2
    np.testing.assert_array_equal(got, _want(world, kind))


@pytest.mark.parametrize("case", ["other_reads", "other_k", "other_d", "other_wave", "torn_sidecar",
                                  "short_partial", "no_partial"])
def test_stale_checkpoint_restarts(world, tmp_path, case):
    """A checkpoint that does not belong to this run is ignored: every wave
    is searched again and the result is right. Another index of the same
    bwtsize is told apart by its k and d (as in tpufm, the text itself is
    not hashed)."""
    reads = world["reads"]
    other = reads.copy()
    other[5, 3] = (other[5, 3] + 1) % 4
    writer = world["search"]
    if case in ("other_k", "other_d"):
        cfg = IndexConfig(k=3, d=D) if case == "other_k" else IndexConfig(k=K, d=128)
        writer = SearchEngine(build_index(world["codes"], cfg), "cpu")
        assert writer.bwtsize == world["search"].bwtsize
    out = _checkpoint(world, tmp_path, "torch", "search", reads=other if case == "other_reads" else reads,
                      engine=writer, wave=64 if case == "other_wave" else WAVE, done=1)
    part, prog = out.with_suffix(".out.partial"), out.with_suffix(".out.progress")
    if case == "torn_sidecar":
        prog.write_text('{"total": 100, "wav')
    elif case == "short_partial":
        part.write_bytes(part.read_bytes()[:-8])
    elif case == "no_partial":
        part.unlink()
    cont = Crashing(world["search"], 99)
    got = stream.search_resumable(cont, reads, out, wave=WAVE)
    assert cont.calls == -(-B // WAVE)
    np.testing.assert_array_equal(got, _want(world, "search"))


def test_identity_and_default_waves(world):
    assert stream._index_identity(world["search"]) == (N + 1, K, D)
    assert stream._index_identity(world["search_locate"]) == (N + 1, K, D)
    assert stream._fingerprint(world["search"], world["reads"]) == jax_stream._fingerprint(
        world["jax_search"], world["reads"])
    assert stream._default_wave(world["search"]) == jax_stream._default_wave(world["jax_search"]) == 1 << 20
    assert stream._default_wave(world["search_locate"]) == jax_stream._default_wave(
        world["jax_search_locate"]) == 1 << 18


# ---- the CLI ---------------------------------------------------------------


@pytest.fixture
def files(tmp_path, world, monkeypatch, capsys):
    """tmp_path/in: g.fa, its .fmi (tpufm's build) and 100 x 24 bp reads;
    the engines' waves cut to WAVE reads so that a run has four."""
    d = tmp_path / "in"
    d.mkdir()
    write_reference(d / "g.fa", decode_bases(world["codes"]))
    write_reads_fasta(d / "q.qry", world["reads"])
    jax_cli.main(["build", str(d / "g.fa"), str(N), "--k", str(K), "--d", str(D), "--output", str(d / "g.fmi")])
    capsys.readouterr()
    for cls in (XLAEngine, SearchEngine):
        monkeypatch.setattr(cls, "WAVE", WAVE)
    for cls in (JaxSearchLocate, SearchLocateEngine):
        monkeypatch.setattr(cls, "WAVE", WAVE)
    return d


def _cli(main, argv, capsys):
    code = None
    try:
        main(argv)
    except SystemExit as e:
        code = e.code
    out = capsys.readouterr()
    return code, [x for x in out.out.splitlines() if not x.startswith("TIME:")], out.err


def _crash_cli(pkg, cls, method, argv, capsys, monkeypatch, done=2):
    """Run ``argv`` through ``pkg``'s CLI with ``cls.method`` raising after
    ``done`` calls (the first wave of waves searched, the checkpoint left)."""
    real = getattr(cls, method)
    left = [done]

    def crashing(self, *args, **kwargs):
        if left[0] == 0:
            raise RuntimeError("simulated crash")
        left[0] -= 1
        return real(self, *args, **kwargs)

    with monkeypatch.context() as m:
        m.setattr(cls, method, crashing)
        with pytest.raises(RuntimeError, match="simulated crash"):
            (torch_cli if pkg == "torch" else jax_cli).main(argv)
    capsys.readouterr()


SEARCH = ["search", "g.fmi", "q.qry", str(L), str(B), "--resume", "--output", "r.res"]
LOCATE = ["locate", "g.fa", str(N), "q.qry", str(L), str(B), "--k", str(K), "--d", str(D), "--sample-rate",
          str(S), "--max-hits", str(HITS), "--resume", "--output", "r.pos"]


@pytest.mark.parametrize("kind", ["search", "locate"])
@pytest.mark.parametrize("rc", [False, True])
@pytest.mark.parametrize("crash", [None, "jax", "torch"])
def test_cli_resume_matches_tpufm(kind, rc, crash, files, tmp_path, monkeypatch, capsys):
    """``search|locate --resume`` (with ``--rc``: 200 reads, seven waves):
    the port's files and lines equal a clean tpufm run's, whether the port
    ran from the start or continued a run that tpufm or the port itself
    left after two waves."""
    argv = [*(SEARCH if kind == "search" else LOCATE), *(["--rc"] if rc else [])]
    port = ["--device", "cpu"]
    runs = {}
    for name in ("jax", "torch"):
        d = tmp_path / name
        shutil.copytree(files, d)
        monkeypatch.chdir(d)
        if name == "torch" and crash:
            cls = {("jax", "search"): XLAEngine, ("torch", "search"): SearchEngine,
                   ("jax", "locate"): JaxSearchLocate, ("torch", "locate"): SearchLocateEngine}[crash, kind]
            _crash_cli(crash, cls, _method(kind), [*argv, *(port if crash == "torch" else [])], capsys, monkeypatch)
            assert any(p.name.endswith(".progress") for p in d.iterdir())
        calls = []
        if name == "torch":
            cls = SearchEngine if kind == "search" else SearchLocateEngine
            real = getattr(cls, _method(kind))
            monkeypatch.setattr(cls, _method(kind), lambda self, *a, **kw: calls.append(1) or real(self, *a, **kw))
        result = _cli(jax_cli.main if name == "jax" else torch_cli.main,
                      [*argv, *(port if name == "torch" else [])], capsys)
        runs[name] = result, {p.name: p.read_bytes() for p in sorted(d.iterdir())}
    assert runs["torch"] == runs["jax"]
    assert len(calls) == -(-B * (1 + rc) // WAVE) - (2 if crash else 0)  # only the waves left
    assert any(name.endswith(".rc") for name in runs["torch"][1]) == rc


def test_cli_search_resume_pallas_engine(files, tmp_path, monkeypatch, capsys):
    """``--engine pallas --resume``: the rows-entry rounds ride the stream
    (``step``), killed after two waves and resumed, to tpufm's bytes."""
    argv = [*SEARCH, "--engine", "pallas"]
    runs = {}
    for name in ("jax", "torch"):
        d = tmp_path / name
        shutil.copytree(files, d)
        monkeypatch.chdir(d)
        if name == "torch":
            _crash_cli("torch", SearchEngine, "search", [*argv, "--device", "cpu"], capsys, monkeypatch)
            rounds, real = [], torch_cli.lf_round_indexed
            monkeypatch.setattr(torch_cli, "lf_round_indexed", lambda *a: rounds.append(1) or real(*a))
        result = _cli(jax_cli.main if name == "jax" else torch_cli.main,
                      [*argv, *(["--device", "cpu"] if name == "torch" else [])], capsys)
        runs[name] = result, {p.name: p.read_bytes() for p in sorted(d.iterdir())}
    assert runs["torch"] == runs["jax"]
    assert len(rounds) == 2 * (L // K)  # the two waves left, each its k-step rounds


def test_cli_search_resume_time_is_the_waves(world, files, monkeypatch, capsys):
    """TIME: is the waves' search seconds, and the run's intervals are the
    oracle's."""
    monkeypatch.chdir(files)
    run = torch_cli.main([*SEARCH, "--device", "cpu"])
    line = [x for x in capsys.readouterr().out.splitlines() if x.startswith("TIME:")]
    assert line == [f"TIME: \t {run.seconds_per_pass}"] and run.seconds_per_pass > 0
    np.testing.assert_array_equal(run.results, _want(world, "search"))


@pytest.mark.parametrize("flag", [["--sam"], ["--bam"], ["--paired", "q.qry"], ["--mismatches", "1"],
                                  ["--edits", "1"]])
def test_cli_locate_resume_refusals(flag, files, monkeypatch, capsys):
    monkeypatch.chdir(files)
    argv = [*LOCATE, *flag]
    got = _cli(torch_cli.main, [*argv, "--device", "cpu"], capsys)
    want = _cli(jax_cli.main, argv, capsys)
    assert got == want
    assert got[0] == "locate --resume covers exact position output; drop --sam/--paired/--mismatches/--edits"
