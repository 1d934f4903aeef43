"""``python -m tpufm_torch.cli search --mesh N [--sharded --routing R]``,
``count --mesh N`` and ``bench --multichip | --sharded`` with ``--device
cpu`` (N CPU shards) against tpufm's CLI on its virtual CPU devices
(tests/conftest.py: 8) on the same index and reads: the result files, the
standard output (its ``TIME:`` lines aside) and every exit text
byte-identical; ``search --mesh N --resume`` killed after one wave and
resumed by either package; the bench records field by field (times
aside). Intervals and counts are integers (tolerance 0)."""

import json
import shutil

import numpy as np
import pytest

from tpufm import cli as jax_cli
from tpufm.io.fasta import write_reference
from tpufm.io.genreads import write_reads_fasta
from tpufm.parallel import DataParallelEngine as JaxDP
from tpufm.parallel import ShardedIndexEngine as JaxSharded
from tpufm.utils.encoding import decode_bases
from tpufm_torch import cli as torch_cli
from tpufm_torch.parallel import DataParallelEngine, ShardedIndexEngine

N, K, D, L, B = 6000, 2, 64, 24, 100


@pytest.fixture
def files(tmp_path, capsys):
    """tmp_path/in: g.fa, tpufm's k=2 d=64 .fmi of it, 100 x 24 bp reads
    (q.qry) and 100 x 25 bp reads (q25.qry, one k=1 tail round)."""
    rng = np.random.default_rng(17)
    codes = rng.integers(0, 4, size=N, dtype=np.uint8)
    starts = rng.integers(0, N - L - 1, size=B)
    d = tmp_path / "in"
    d.mkdir()
    write_reference(d / "g.fa", decode_bases(codes))
    write_reads_fasta(d / "q.qry", codes[starts[:, None] + np.arange(L)])
    write_reads_fasta(d / "q25.qry", codes[starts[:, None] + np.arange(L + 1)])
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


def _both(files, tmp_path, monkeypatch, capsys, argv, outputs=("r.out", "r.out.rc")):
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
    [(L, ["--mesh", "4"]), (L, ["--mesh", "4", "--lut", "4", "--rc"]), (L, ["--mesh", "3", "--engine", "xla-ac"]),
     (L + 1, ["--mesh", "4", "--lut", "4"]), (L, ["--sharded", "--mesh", "4"]),
     (L, ["--sharded", "--mesh", "4", "--routing", "ring", "--lut", "4"]),
     (L, ["--sharded", "--mesh", "8", "--routing", "a2a"]),
     (L + 1, ["--sharded", "--mesh", "4", "--routing", "a2a", "--lut", "4", "--rc"]),
     (L, ["--mesh", "4", "--engine", "pallas"]), (L, ["--sharded", "--mesh", "4", "--engine", "xla-ac"])],
    ids=["dp", "dp-lut-rc", "dp-ac", "dp-tail", "allgather", "ring-lut", "a2a-8", "a2a-tail-rc", "pallas-exit",
         "sharded-ac-exit"],
)
def test_search_mesh_byte_identical(files, tmp_path, monkeypatch, capsys, length, flags):
    argv = ["search", "g.fmi", f"q{'' if length == L else length}.qry", str(length), str(B), "--iterations", "1",
            "--output", "r.out", *flags]
    jax_run, torch_run = _both(files, tmp_path, monkeypatch, capsys, argv)
    assert torch_run == jax_run
    refused = "pallas" in flags or ("--sharded" in flags and "xla-ac" in flags)
    assert isinstance(torch_run[0][0], str) if refused else torch_run[0][0] is None and torch_run[1]["r.out"]


@pytest.mark.parametrize("flags", [["--mesh", "4"], ["--mesh", "4", "--mismatches", "1", "--lut", "4"],
                                   ["--mesh", "2", "--rc"]], ids=["exact", "hamming1", "rc"])
def test_count_mesh_byte_identical(files, tmp_path, monkeypatch, capsys, flags):
    argv = ["count", "g.fmi", "q.qry", str(L), str(B), "--output", "r.out", *flags]
    jax_run, torch_run = _both(files, tmp_path, monkeypatch, capsys, argv)
    assert torch_run == jax_run and torch_run[0][0] is None and torch_run[1]["r.out"]


@pytest.mark.parametrize("sharded", [False, True], ids=["mesh", "sharded"])
def test_search_mesh_resume_crossed_with_tpufm(files, tmp_path, monkeypatch, capsys, sharded):
    """``search --mesh 3 --resume`` (and ``--sharded``): waves of a mesh
    multiple, the last padded by cycling its reads; killed after one wave,
    the checkpoint is tpufm's byte for byte, and either package finishes
    the other's run with tpufm's files and lines."""
    if sharded:
        for cls in (JaxSharded, ShardedIndexEngine):
            monkeypatch.setattr(cls, "WAVE_PER_CHIP", 13)  # waves of 39 reads
    else:
        for cls in (JaxDP, DataParallelEngine):
            monkeypatch.setattr(cls, "WAVE", 40, raising=False)  # rounded down to 39
    argv = ["search", "g.fmi", "q.qry", str(L), str(B), "--resume", "--mesh", "3", "--lut", "4", "--output",
            "r.out", *(["--sharded", "--routing", "a2a"] if sharded else [])]
    engines = {"jax": JaxSharded if sharded else JaxDP, "torch": ShardedIndexEngine if sharded else DataParallelEngine}
    mains = {"jax": (jax_cli.main, []), "torch": (torch_cli.main, ["--device", "cpu"])}
    want, progress = None, {}
    for crash, finish in ((None, "jax"), ("torch", "torch"), ("torch", "jax"), ("jax", "torch")):
        d = tmp_path / f"run-{crash}-{finish}"
        shutil.copytree(files, d)
        monkeypatch.chdir(d)
        if crash:
            cls = engines[crash]
            real, left = cls.search, [1]

            def crashing(self, *a, **kw):
                if not left[0]:
                    raise RuntimeError("simulated crash")
                left[0] -= 1
                return real(self, *a, **kw)

            main, extra = mains[crash]
            with monkeypatch.context() as m:
                m.setattr(cls, "search", crashing)
                with pytest.raises(RuntimeError, match="simulated crash"):
                    main([*argv, *extra])
            capsys.readouterr()
            progress[crash] = ((d / "r.out.progress").read_bytes(), (d / "r.out.partial").read_bytes())
        main, extra = mains[finish]
        run = _cli(main, [*argv, *extra], capsys)
        got = run, (d / "r.out").read_bytes(), sorted(p.name for p in d.iterdir() if "progress" in p.name)
        want = want or got
        assert got == want
    assert progress["torch"] == progress["jax"]
    assert json.loads(progress["torch"][0])["wave"] == 39


def _record(main, argv, capsys) -> dict:
    main(argv)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    return json.loads(lines[0])


#: the fields of a mesh record that depend on the clock
TIMED = {"value", "vs_baseline", "scaling_efficiency", "reads_per_s_one_chip", "reads_per_s_per_chip",
         "seconds_per_pass", "pass_seconds", "seconds_per_pass_median", "one_device_pass_seconds"}


@pytest.mark.parametrize("mode", [["--multichip"], ["--sharded", "--routing", "ring"],
                                  ["--sharded", "--routing", "a2a"]], ids=["multichip", "ring", "a2a"])
def test_bench_mesh_records_match_tpufm(capsys, mode):
    """The record of each mesh bench mode on 8 shards (tpufm's CLI takes
    every device, the port ``--mesh 8``): the same metric, unit and fields,
    equal but for the times; the port's adds its device fields."""
    argv = ["bench", *mode, "--refsize", "20000", "--numqueries", "256", "--length", "24", "--k", "2", "--d", "64",
            "--lut", "4", "--iterations", "1", "--mesh", "8"]
    want = _record(jax_cli.main, argv, capsys)
    got = _record(torch_cli.main, [*argv, "--device", "cpu"], capsys)
    assert got["metric"] == want["metric"] and got["unit"] == want["unit"]
    assert [f for f in got["detail"] if f in want["detail"]] == list(want["detail"])
    for field, value in want["detail"].items():
        if field not in TIMED:
            assert got["detail"][field] == value, field
    assert got["detail"]["devices"] == 8 and got["detail"]["bit_exact_vs_oracle"] is True
    assert got["detail"]["device"] == "cpu" and len(got["detail"]["one_device_pass_seconds"]) == 1


def test_mesh_exits_name_their_items(files, monkeypatch, capsys):
    """A per-shard store without --sharded, ``build --mesh`` without
    ``--on-device`` and ``--store-sharded`` without a ``.tpufm`` output:
    tpufm's exits, word for word (the sharded build of item 6c is ported:
    its files against tpufm's in tests/test_torch_build_sharded_cli.py).
    ``bench --locate --mesh 2`` is ported: it prints its record over two
    CPU shards."""
    monkeypatch.chdir(files)
    store = files / "s.tpufm"
    store.mkdir()
    (store / "meta.json").write_text(json.dumps({"kind": "kstep_sharded"}))
    for argv in (["search", "s.tpufm", "q.qry", str(L), str(B)], ["build", "g.fa", str(N), "--mesh", "2"],
                 ["build", "g.fa", str(N), "--on-device", "--mesh", "2", "--store-sharded", "--output", "x.fmi"]):
        jax_exit = _cli(jax_cli.main, argv, capsys)
        assert _cli(torch_cli.main, [*argv, "--device", "cpu"], capsys) == jax_exit and jax_exit[0], argv
    code, out, _ = _cli(torch_cli.main, ["bench", "--locate", "--mesh", "2", "--refsize", "20000", "--numqueries",
                                         "1001", "--iterations", "1", "--device", "cpu"], capsys)
    record = json.loads(out[-1])
    assert code is None and record["detail"]["devices"] == 2 and record["detail"]["bit_exact_vs_oracle"] is True
    assert "over 2 device(s)" in record["metric"] and "1000 rows" in record["metric"]
