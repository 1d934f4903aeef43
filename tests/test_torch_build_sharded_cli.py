"""``python -m tpufm_torch.cli build --on-device --mesh N [--tail]
[--store-sharded]``, ``build --sa sharded``, ``search X.tpufm --sharded``
of a per-shard store, and ``locate`` / ``align --on-device --mesh N`` with
``--device cpu`` (N CPU shards) against tpufm's CLI on its virtual CPU
devices (tests/conftest.py: 8) on the same reference and reads: the
``.fmi``, ``.tail.npz``, store files, ``.res``, ``.pos``, ``.pairs``, SAM
and BAM byte-identical, and what each prints; the argument errors of a
sharded build with tpufm's texts. Every output is integers or text
(tolerance 0)."""

import shutil
import time

import pytest
from test_torch_align import data  # noqa: F401 (a fixture)
from test_torch_parallel_locate_cli import L, REFSIZE, _pair, files  # noqa: F401 (files is a fixture)

from tpufm import cli as jax_cli
from tpufm_torch import cli as torch_cli

K, D = 2, 64


@pytest.fixture(autouse=True)
def _still_clock(monkeypatch):
    """An .npz's zip members carry the write time: hold it still."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)


def _tree(path):
    return {p.name: p.read_bytes() for p in sorted(path.iterdir())} if path.is_dir() else path.read_bytes()


def _same_files(tmp_path, names):
    for name in names:
        a, b = tmp_path / "jax" / name, tmp_path / "torch" / name
        assert a.exists() and _tree(b) == _tree(a), name


BUILD_FORMS = {
    "mesh4": (["--on-device", "--mesh", "4", "--output", "x.fmi"], ["x.fmi"]),
    "mesh8-tail": (["--on-device", "--mesh", "8", "--tail", "--output", "x.fmi"], ["x.fmi", "x.fmi.tail.npz"]),
    "mesh4-npz": (["--on-device", "--mesh", "4", "--output", "x.npz"], ["x.npz"]),
    "store-sharded-tail": (["--on-device", "--mesh", "4", "--store-sharded", "--tail", "--output", "x.tpufm"],
                           ["x.tpufm", "x.tpufm.tail.npz"]),
    "store-sharded-k1": (["--on-device", "--mesh", "8", "--store-sharded", "--k", "1", "--tail",
                          "--output", "x.tpufm"], ["x.tpufm", "x.tpufm.tail.npz"]),
    "sa-sharded": (["--sa", "sharded", "--tail", "--output", "x.fmi"], ["x.fmi", "x.fmi.tail.npz"]),
    "store-needs-tpufm": (["--on-device", "--mesh", "4", "--store-sharded", "--output", "x.fmi"], []),
    "store-needs-mesh": (["--on-device", "--store-sharded", "--output", "x.tpufm"], []),
}


@pytest.mark.parametrize("form", list(BUILD_FORMS))
def test_build_sharded_byte_identical(files, tmp_path, monkeypatch, capsys, form):
    """Each build form's files byte for byte tpufm's (a per-shard store's
    every file), its printed lines alike (the build's seconds aside), or
    tpufm's exit text; ``--sa sharded`` sorts over one CPU shard here and
    over tpufm's eight devices there."""
    flags, outputs = BUILD_FORMS[form]
    argv = ["build", "g.fa", str(REFSIZE), "--k", str(K), "--d", str(D), *flags]
    jax_run, torch_run = _pair(files, tmp_path, monkeypatch, capsys, argv, ())
    strip = [[x for x in r[0][1] if not x.startswith("built ")] for r in (jax_run, torch_run)]
    assert torch_run[0][0] == jax_run[0][0] and strip[1] == strip[0]
    assert bool(jax_run[0][0]) == (not outputs)
    _same_files(tmp_path, outputs)


@pytest.mark.parametrize("routing,mesh,length,tail", [
    ("allgather", "4", L, True), ("ring", "4", L + 1, True), ("a2a", "4", L, True), ("allgather", "4", L + 1, False),
    ("allgather", "0", L, True)])
def test_search_store_sharded_byte_identical(files, tmp_path, monkeypatch, capsys, routing, mesh, length, tail):
    """A per-shard store written by tpufm on 4 devices, searched by each
    package with ``--sharded --mesh 4 --routing R`` (``--mesh 0``: tpufm's
    every device, which the store refuses, as the port's one CPU shard
    does), 24 bp reads and 25 bp (the k=1 tail from the store's
    ``.tail.npz``, or without one derived from the store's tables),
    ``--lut 4``: the ``.res`` byte-identical."""
    shutil.copytree(files, tmp_path / "in")
    monkeypatch.chdir(tmp_path / "in")
    jax_cli.main(["build", "g.fa", str(REFSIZE), "--k", str(K), "--d", str(D), "--on-device", "--mesh", "4",
                  "--store-sharded", *(["--tail"] if tail else []), "--output", "s.tpufm"])
    capsys.readouterr()
    reads = "q.qry" if length == L else "q25.qry"
    argv = ["search", "s.tpufm", reads, str(length), "100", "--sharded", "--mesh", mesh, "--routing", routing,
            "--lut", "4", "--iterations", "1", "--output", "r.res"]
    for name, main, extra in (("jax", jax_cli.main, []), ("torch", torch_cli.main, ["--device", "cpu"])):
        shutil.copytree(tmp_path / "in", tmp_path / name)
        monkeypatch.chdir(tmp_path / name)
        if mesh == "0":
            with pytest.raises(ValueError, match="store has 4 shards; mesh has"):
                main([*argv, *extra])
        else:
            main([*argv, *extra])
    if mesh != "0":
        _same_files(tmp_path, ["r.res"])


LOCATE_FORMS = {
    "two-pass": [],
    "fused-store": ["--fused", "--store", "S"],
    "rc-lut": ["--fused", "--rc", "--lut", "4"],
    "hamming1": ["--mismatches", "1"],
    "hamming2": ["--mismatches", "2", "--seed-hits", "16"],
    "edits1": ["--edits", "1", "--lut", "4"],
    "sam": ["--sam"],
    "paired": ["--paired", "p_2.qry", "--insert-max", "300"],
}


@pytest.mark.parametrize("form", list(LOCATE_FORMS))
def test_locate_on_device_mesh_byte_identical(files, tmp_path, monkeypatch, capsys, form):
    """``locate --on-device --mesh 4`` (one sharded sort for the index and
    the locate tables, then the mesh engines) in each form: the output
    (and ``--store``'s stores) byte-identical, the same lines printed."""
    flags = LOCATE_FORMS[form]
    reads, n = ("p_1.qry", 40) if "--paired" in flags else ("q.qry", 100)
    argv = ["locate", "g.fa", str(REFSIZE), reads, str(L), str(n), "--k", str(K), "--d", str(D),
            "--sample-rate", "8", "--max-hits", "6", "--on-device", "--mesh", "4", "--output", "r.out", *flags]
    jax_run, torch_run = _pair(files, tmp_path, monkeypatch, capsys, argv, ("r.out", "r.out.rc"))
    assert torch_run == jax_run and torch_run[0][0] is None and torch_run[1]["r.out"]
    if "--store" in flags:
        _same_files(tmp_path, ["S.search.tpufm", "S.locate.tpufm"])


@pytest.mark.parametrize("form", ["exact", "paired-bam", "mixed-m1"])
def test_align_on_device_mesh_byte_identical(data, tmp_path, capsys, form):  # noqa: F811
    """``align --on-device --mesh 4``: the SAM or BAM byte-identical to
    tpufm's (fixed-length reads, FR pairs as BAM, mixed lengths within one
    substitution), the same lines printed."""
    reads, extra = {"exact": ("fixed", []), "paired-bam": ("r1", ["-2", data["r2"], "--bam"]),
                    "mixed-m1": ("mixed", ["--mismatches", "1"])}[form]
    common = ["align", data["ref"], data[reads], "--sample-rate", "8", "--max-hits", "6", "--on-device",
              "--mesh", "4", *extra]
    jax_cli.main([*common, "-o", str(tmp_path / "j.out")])
    said_jax = capsys.readouterr().out.replace(str(tmp_path / "j.out"), "OUT")
    torch_cli.main([*common, "-o", str(tmp_path / "t.out"), "--device", "cpu"])
    said_torch = capsys.readouterr().out.replace(str(tmp_path / "t.out"), "OUT")
    assert (tmp_path / "t.out").read_bytes() == (tmp_path / "j.out").read_bytes() and said_torch == said_jax
