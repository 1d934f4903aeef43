"""``python -m tpufm_torch.cli search --engine xla-ac | xla-paired``,
``--pad-words`` and ``--resume`` with those engines, with ``--device cpu``,
against ``tpufm search`` on the same index and reads: the results files,
the standard output (its ``TIME:`` lines aside) and error, and every exit
text byte-identical (intervals are integers; tolerance 0)."""

import shutil

import numpy as np
import pytest

from tpufm import cli as jax_cli
from tpufm.engine.xla import XLAEngine
from tpufm.io.fasta import write_reference
from tpufm.io.genreads import write_reads_fasta
from tpufm.utils.encoding import decode_bases
from tpufm_torch import SearchEngine
from tpufm_torch import cli as torch_cli

N, K, D, L, B = 4000, 2, 64, 24, 100


@pytest.fixture
def files(tmp_path, capsys):
    """tmp_path/in: g.fa (a period-4 repeat in its middle, so that the
    paired layout repairs), tpufm's k=2 d=64 .fmi of it and 100 x 24 bp
    reads, a third of them from the repeat."""
    rng = np.random.default_rng(13)
    codes = rng.integers(0, 4, size=N, dtype=np.uint8)
    codes[1000:2000] = np.tile(np.arange(4, dtype=np.uint8), 250)
    starts = rng.integers(0, N - L - 1, size=B)
    starts[:30] = rng.integers(1000, 1900, size=30)
    d = tmp_path / "in"
    d.mkdir()
    write_reference(d / "g.fa", decode_bases(codes))
    write_reads_fasta(d / "q.qry", codes[starts[:, None] + np.arange(L)])
    write_reads_fasta(d / "q25.qry", codes[starts[:, None] + np.arange(L + 1)])  # one k=1 tail round
    jax_cli.main(["build", str(d / "g.fa"), str(N), "--k", str(K), "--d", str(D), "--output", str(d / "g.fmi")])
    capsys.readouterr()
    return d


def _cli(main, argv, capsys):
    """(exit code or None, stdout lines without TIME:, stderr) of one run."""
    code = None
    try:
        main(argv)
    except SystemExit as e:
        code = e.code
    out = capsys.readouterr()
    return code, [x for x in out.out.splitlines() if not x.startswith("TIME:")], out.err


def _both(files, tmp_path, monkeypatch, capsys, argv, outputs=("r.res", "r.res.rc")):
    """``argv`` through tpufm's CLI and the port's (``--device cpu``), each
    in a copy of ``files``: (jax, torch), each (run, {output: bytes})."""
    runs = []
    for name, main, extra in (("jax", jax_cli.main, []), ("torch", torch_cli.main, ["--device", "cpu"])):
        d = tmp_path / name
        shutil.copytree(files, d)
        monkeypatch.chdir(d)
        run = _cli(main, [*argv, *extra], capsys)
        runs.append((run, {o: (d / o).read_bytes() for o in outputs if (d / o).exists()}))
    return runs


@pytest.mark.parametrize(
    "length,flags",
    [(L, ["--engine", "xla-ac"]), (L, ["--engine", "xla-ac", "--rc"]), (L, ["--engine", "xla-paired", "--lut", "4"]),
     (L, ["--engine", "xla-paired", "--lut", "4", "--rc"]), (L, ["--pad-words", "128"]),
     (L, ["--pad-words", "128", "--lut", "4"]), (L + 1, ["--engine", "xla-paired", "--lut", "6"])],
    ids=["ac", "ac-rc", "paired", "paired-rc", "pad", "pad-lut", "paired-tail"],
)
def test_search_engines_byte_identical(files, tmp_path, monkeypatch, capsys, length, flags):
    argv = ["search", "g.fmi", f"q{'' if length == L else length}.qry", str(length), str(B), "--iterations", "1",
            "--output", "r.res", *flags]
    jax_run, torch_run = _both(files, tmp_path, monkeypatch, capsys, argv)
    assert torch_run == jax_run
    assert torch_run[0][0] is None and torch_run[1]["r.res"]


@pytest.mark.parametrize(
    "length,flags",
    [(L, ["--engine", "xla-paired"]), (L + 1, ["--engine", "xla-ac"]), (L + 1, ["--engine", "pallas"]),
     (L, ["--engine", "xla-ac", "--lut", "4"])],
    ids=["paired-no-lut", "ac-tail", "pallas-tail", "ac-lut"],
)
def test_search_engine_refusals_byte_identical(files, tmp_path, monkeypatch, capsys, length, flags):
    """Each refusal: tpufm's exit text (or ValueError) and what was printed
    before it, word for word."""
    argv = ["search", "g.fmi", f"q{'' if length == L else length}.qry", str(length), str(B), "--iterations", "1",
            "--output", "r.res", *flags]
    if "--lut" in flags:  # alternate counters with a LUT: XLAEngine's ValueError
        monkeypatch.chdir(files)
        for main, extra in ((jax_cli.main, []), (torch_cli.main, ["--device", "cpu"])):
            with pytest.raises(ValueError, match="^lut_m is not supported with alt-counters$"):
                main([*argv, *extra])
        return
    jax_run, torch_run = _both(files, tmp_path, monkeypatch, capsys, argv)
    assert torch_run == jax_run and isinstance(torch_run[0][0], str) and torch_run[1] == {}


def test_search_mesh_exits_naming_item_6(files, monkeypatch):
    """``search --mesh`` and ``--sharded`` are ported (item 6a; their bytes
    against tpufm's: tests/test_torch_parallel_cli.py), and so is the
    per-shard .tpufm store (item 6c): one written by ``build --on-device
    --mesh 2 --store-sharded`` searches with ``--sharded --mesh 2`` to the
    whole index's intervals."""
    monkeypatch.chdir(files)
    runs = []
    for flag in (["--mesh", "2"], ["--sharded"]):
        run = torch_cli.main(["search", "g.fmi", "q.qry", str(L), str(B), *flag, "--iterations", "1",
                              "--device", "cpu", "--output", "m.res"])
        assert (run.results[:, 1] > run.results[:, 0]).all()
        runs.append(run.results)
    torch_cli.main(["build", "g.fa", str(N), "--k", str(K), "--d", str(D), "--on-device", "--mesh", "2",
                    "--store-sharded", "--output", "s.tpufm", "--device", "cpu"])
    run = torch_cli.main(["search", "s.tpufm", "q.qry", str(L), str(B), "--sharded", "--mesh", "2",
                          "--iterations", "1", "--device", "cpu", "--output", "s.res"])
    assert all(np.array_equal(run.results, r) for r in runs)


@pytest.mark.parametrize("engine", ["xla-ac", "xla-paired"])
def test_search_resume_with_engine_matches_tpufm(files, tmp_path, monkeypatch, capsys, engine):
    """``search --resume --engine xla-ac | xla-paired``: the port killed
    after two of four waves and resumed writes tpufm's files and lines; a
    run tpufm left after two waves the port continues."""
    for cls in (XLAEngine, SearchEngine):
        monkeypatch.setattr(cls, "WAVE", 32)
    lut = ["--lut", "4"] if engine == "xla-paired" else []
    argv = ["search", "g.fmi", "q.qry", str(L), str(B), "--resume", "--engine", engine, "--output", "r.res", *lut]
    want = None
    for crash in (None, "torch", "jax"):
        d = tmp_path / f"run-{crash}"
        shutil.copytree(files, d)
        monkeypatch.chdir(d)
        main = jax_cli.main if crash is None else torch_cli.main
        extra = [] if crash is None else ["--device", "cpu"]
        if crash:
            cls, crash_main = (SearchEngine, torch_cli.main) if crash == "torch" else (XLAEngine, jax_cli.main)
            real, left = cls.search, [2]

            def crashing(self, *a, **kw):
                if not left[0]:
                    raise RuntimeError("simulated crash")
                left[0] -= 1
                return real(self, *a, **kw)

            with monkeypatch.context() as m:
                m.setattr(cls, "search", crashing)
                with pytest.raises(RuntimeError, match="simulated crash"):
                    crash_main([*argv, *([] if crash == "jax" else ["--device", "cpu"])])
            capsys.readouterr()
            assert (d / "r.res.progress").exists()
        run = _cli(main, [*argv, *extra], capsys)
        got = run, (d / "r.res").read_bytes(), sorted(p.name for p in d.iterdir() if "progress" in p.name)
        want = want or got
        assert got == want
