"""``python -m tpufm_torch.cli search|count|locate --device cpu`` against
``tpufm search|count|locate`` on the same reference, index and query files:
the .res, .cnt and .pos files (and their .rc siblings) must be
byte-identical (intervals, counts and positions are integers; tolerance 0),
and the .tpufm stores each package writes must load in the other."""

import numpy as np
import pytest
import torch

from tpufm import cli as jax_cli
from tpufm.config import IndexConfig as JaxIndexConfig
from tpufm.index.builder import build_index as jax_build_index
from tpufm.index.formats import read_fmi, save_npz
from tpufm.io.fasta import write_reference
from tpufm.io.genreads import generate_reads, write_reads_fasta
from tpufm.utils.encoding import decode_bases
from tpufm_torch import cli as torch_cli


@pytest.fixture
def fmi(tmp_path, rng):
    n = 3000
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    ref = tmp_path / "ref.fa"
    write_reference(ref, decode_bases(codes))
    path = tmp_path / "ref.fmi"
    jax_cli.main(["build", str(ref), str(n), "--k", "2", "--d", "64", "--output", str(path)])
    return codes, path


def _qry(tmp_path, codes, L, n, seed):
    path = tmp_path / f"reads{L}.qry"
    reads, starts = generate_reads(codes, L, n, seed=seed, return_starts=True)
    write_reads_fasta(path, reads, starts)
    return path


@pytest.mark.parametrize("fmt,lut", [("fmi", 0), ("fmi", 4), ("npz", 0)])
def test_res_byte_identical(tmp_path, fmi, capsys, fmt, lut):
    codes, path = fmi
    if fmt == "npz":
        index, _ = read_fmi(path)
        path = tmp_path / "ref.npz"
        save_npz(path, index)
    qry = _qry(tmp_path, codes, 24, 64, seed=3)
    args = ["search", str(path), str(qry), "24", "64", "--iterations", "1", "--lut", str(lut)]
    jax_cli.main(args + ["--output", str(tmp_path / "jax.res")])
    run = torch_cli.main(args + ["--device", "cpu", "--output", str(tmp_path / "torch.res")])
    assert (tmp_path / "torch.res").read_bytes() == (tmp_path / "jax.res").read_bytes()
    assert capsys.readouterr().out.count("TIME: \t ") == 2
    if lut:  # tpufm search left <index>.lut4.npz; the port loaded it
        assert run.engine.lut_build_seconds is None


def test_any_length_both_strands_byte_identical(tmp_path, fmi):
    codes, path = fmi
    qry = _qry(tmp_path, codes, 25, 48, seed=5)  # 25 % 2: one k=1 tail round
    args = ["search", str(path), str(qry), "25", "48", "--iterations", "1", "--rc"]
    jax_cli.main(args)
    run = torch_cli.main(args + ["--device", "cpu"])
    for suffix in ("", ".rc"):
        ours = path.parent / f"{path.name}.res.cpu{suffix}"
        assert ours.read_bytes() == (path.parent / f"{path.name}.res.tpu{suffix}").read_bytes()
    assert run.results.shape == (96, 2)
    assert (run.results[:48, 1] > run.results[:48, 0]).all()


def test_cli_argument_errors(tmp_path, fmi):
    codes, path = fmi
    qry = _qry(tmp_path, codes, 24, 8, seed=1)
    with pytest.raises(SystemExit):
        torch_cli.main(["search", str(path), str(qry), "24", "8", "--iterations", "0"])
    if torch.cuda.is_available():
        return
    # the default device is cuda, with no fallback to the CPU
    with pytest.raises(RuntimeError, match="cuda"):
        torch_cli.main(["search", str(path), str(qry), "24", "8"])


@pytest.mark.parametrize("lut", [0, 4])
def test_engine_pallas_res_byte_identical(tmp_path, fmi, lut):
    codes, path = fmi
    qry = _qry(tmp_path, codes, 24, 64, seed=7)
    args = ["search", str(path), str(qry), "24", "64", "--iterations", "1",
            "--lut", str(lut), "--engine", "pallas"]
    jax_cli.main(args + ["--output", str(tmp_path / "jax.res")])
    run = torch_cli.main(args + ["--device", "cpu", "--output", str(tmp_path / "torch.res")])
    assert (tmp_path / "torch.res").read_bytes() == (tmp_path / "jax.res").read_bytes()
    assert (run.results[:, 1] > run.results[:, 0]).all()


def test_engine_pallas_refuses_a_tail(tmp_path, fmi):
    codes, path = fmi
    qry = _qry(tmp_path, codes, 25, 8, seed=9)  # 25 % 2: needs the k=1 tail
    args = ["search", str(path), str(qry), "25", "8", "--engine", "pallas"]
    with pytest.raises(SystemExit) as jax_exit:
        jax_cli.main(args)
    with pytest.raises(SystemExit) as torch_exit:
        torch_cli.main(args + ["--device", "cpu"])
    assert "pad reads to a multiple of k for pallas" in str(torch_exit.value.code)
    assert torch_exit.value.code == jax_exit.value.code


@pytest.fixture
def ref(tmp_path, rng):
    n = 3000
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    path = tmp_path / "g.fa"
    write_reference(path, decode_bases(codes))
    return codes, path


def _pos_lines(path):
    return [[int(x) for x in line.split()] for line in path.read_text().splitlines()]


@pytest.mark.parametrize(
    "extra",
    [[], ["--fused"], ["--rc"], ["--fused", "--rc"], ["--mismatches", "1"],
     ["--mismatches", "1", "--rc"], ["--lut", "4"], ["--fused", "--lut", "4"]],
    ids=["two-pass", "fused", "rc", "fused-rc", "mm1", "mm1-rc", "lut", "fused-lut"],
)
def test_locate_pos_byte_identical(tmp_path, ref, capsys, extra):
    """``locate`` (25 bp reads at k=2: one tail round, on the locate rows
    when fused) writes tpufm's .pos bytes, plus .pos.rc with --rc."""
    codes, fa = ref
    reads, starts = generate_reads(codes, 25, 40, seed=11, return_starts=True)
    if "--mismatches" in extra:
        at = np.random.default_rng(2).integers(0, 25, size=40)
        reads[np.arange(40), at] = (reads[np.arange(40), at] + 1) % 4  # one substitution each
    qry = tmp_path / "q.qry"
    write_reads_fasta(qry, reads, starts)
    args = ["locate", str(fa), "3000", str(qry), "25", "40", "--k", "2", "--d", "64",
            "--sample-rate", "8", "--max-hits", "6", *extra]
    jax_cli.main(args + ["--output", str(tmp_path / "jax.pos")])
    run = torch_cli.main(args + ["--device", "cpu", "--output", str(tmp_path / "torch.pos")])
    suffixes = ["", ".rc"] if "--rc" in extra else [""]
    for suffix in suffixes:
        ours = tmp_path / f"torch.pos{suffix}"
        assert ours.read_bytes() == (tmp_path / f"jax.pos{suffix}").read_bytes(), suffix
    assert not (tmp_path / "torch.pos.rc").exists() or "--rc" in extra
    assert run.positions.shape == (40 * len(suffixes), 6)
    assert (run.intervals is None) == ("--mismatches" in extra)
    # every read's origin is among its positions (fewer than 6 hits at 3 kbase)
    for line, s in zip(_pos_lines(tmp_path / "torch.pos"), starts):
        assert int(s) in line
    assert capsys.readouterr().out.count("40 queries, max 6 hits each") == 2


@pytest.mark.parametrize("writer", ["port", "tpufm"])
def test_locate_stores_load_across(tmp_path, ref, writer):
    """``--store`` by one package, ``--from-store`` by the other: the same
    positions as a build from the reference."""
    codes, fa = ref
    qry = tmp_path / "q.qry"
    reads, starts = generate_reads(codes, 24, 30, seed=12, return_starts=True)
    write_reads_fasta(qry, reads, starts)
    tail = [str(qry), "24", "30", "--k", "2", "--d", "64", "--sample-rate", "8"]
    store, load = (torch_cli.main, jax_cli.main) if writer == "port" else (jax_cli.main, torch_cli.main)
    dev = lambda fn: ["--device", "cpu"] if fn is torch_cli.main else []  # noqa: E731
    store(["locate", str(fa), "3000", *tail, "--store", str(tmp_path / "P"),
           "--output", str(tmp_path / "a.pos"), *dev(store)])
    assert (tmp_path / "P.search.tpufm" / "meta.json").exists()
    assert (tmp_path / "P.locate.tpufm" / "lf1_occ.npy").exists()
    load(["locate", "-", "0", *tail, "--from-store", str(tmp_path / "P"), "--fused",
          "--output", str(tmp_path / "b.pos"), *dev(load)])
    assert (tmp_path / "a.pos").read_bytes() == (tmp_path / "b.pos").read_bytes()


@pytest.mark.parametrize("option", [["--mismatches", "2"], ["--edits", "1"], ["--sam"], ["--mesh", "4"]])
def test_locate_refuses_options_outside_the_slice(tmp_path, ref, option):
    _, fa = ref
    with pytest.raises(SystemExit) as exit_info:
        torch_cli.main(["locate", str(fa), "3000", "q.qry", "24", "8", *option, "--device", "cpu"])
    assert exit_info.value.code == 2  # argparse's usage error


@pytest.mark.parametrize(
    "extra",
    [[], ["--mismatches", "1"], ["--rc"], ["--mismatches", "1", "--rc", "--lut", "4"], ["--tail"]],
    ids=["exact", "mm1", "rc", "mm1-rc-lut", "tail-file"],
)
def test_count_cnt_byte_identical(tmp_path, fmi, capsys, extra):
    """``count`` of 25 bp reads (one tail round at k=2) writes tpufm's .cnt
    bytes, plus .cnt.rc with --rc; --tail reads a k=1 index file."""
    codes, path = fmi
    qry = _qry(tmp_path, codes, 25, 48, seed=13)
    if extra == ["--tail"]:
        tail = tmp_path / "tail.npz"
        save_npz(tail, jax_build_index(codes, JaxIndexConfig(k=1, d=64), sa_method="doubling"))
        extra = ["--tail", str(tail), "--mismatches", "1"]
    args = ["count", str(path), str(qry), "25", "48", *extra]
    jax_cli.main(args + ["--output", str(tmp_path / "jax.cnt")])
    run = torch_cli.main(args + ["--device", "cpu", "--output", str(tmp_path / "torch.cnt")])
    for suffix in ["", ".rc"] if "--rc" in extra else [""]:
        assert (tmp_path / f"torch.cnt{suffix}").read_bytes() == (tmp_path / f"jax.cnt{suffix}").read_bytes()
    assert (run.counts[:48] >= 1).all()
    out = capsys.readouterr().out
    assert out.count("TIME: \t ") == 2
    assert ("deriving the k=1 tail" in out) == ("--tail" not in extra)


def test_count_and_search_refuse_a_locate_store(tmp_path, ref):
    _, fa = ref
    jax_cli.main(["locate", str(fa), "3000", str(fa), "70", "1", "--store", str(tmp_path / "P"),
                  "--output", str(tmp_path / "x.pos")])
    for cmd in ("count", "search"):
        with pytest.raises(SystemExit, match="not a search index"):
            torch_cli.main([cmd, str(tmp_path / "P.locate.tpufm"), str(fa), "70", "1", "--device", "cpu"])
