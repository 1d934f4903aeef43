"""``python -m tpufm_torch.cli search|count|locate --device cpu`` against
``tpufm search|count|locate`` on the same reference, index and query files:
the .res, .cnt and .pos files (and their .rc siblings) must be
byte-identical (intervals, counts and positions are integers; tolerance 0),
and the .tpufm stores each package writes must load in the other."""

import json

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


@pytest.mark.parametrize("option", [["--sam"], ["--bam"], ["--contigs"], ["--mesh", "4"]])
def test_locate_refuses_options_outside_the_slice(tmp_path, ref, option):
    """SAM and BAM output, the contig map and the mesh locate (--mesh 4: the
    port's four CPU shards, tpufm's four virtual devices) are ported: the
    port writes tpufm's bytes (the '> 3000' header names the one record
    '3000')."""
    codes, fa = ref
    qry = tmp_path / "q.qry"
    reads, starts = generate_reads(codes, 24, 8, seed=13, return_starts=True)
    write_reads_fasta(qry, reads, starts)
    args = ["locate", str(fa), "3000", str(qry), "24", "8", *option]
    jax_cli.main([*args, "--output", str(tmp_path / "jax.out")])
    torch_cli.main([*args, "--device", "cpu", "--output", str(tmp_path / "torch.out")])
    assert (tmp_path / "torch.out").read_bytes() == (tmp_path / "jax.out").read_bytes()
    if option[0] == "--contigs":
        assert all(line.startswith("3000:") for line in (tmp_path / "torch.out").read_text().splitlines())


def _mutated_reads(codes, L, n, seed, kind):
    """(reads, starts): text windows with two substitutions each ("sub"), or
    with two edits each (substitution, deletion or insertion) cut to L."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(codes) - L - 2, size=n)
    reads = []
    for s0 in starts:
        w = list(codes[s0 : s0 + L + 2])
        for p in rng.choice(L, size=2, replace=False):
            op = 0 if kind == "sub" else rng.integers(0, 3)
            if op == 0:
                w[p] = (w[p] + int(rng.integers(1, 4))) & 3
            elif op == 1:
                del w[p]
            else:
                w.insert(p, int(rng.integers(0, 4)))
        reads.append(np.array(w[:L], np.uint8))
    return np.stack(reads), starts


@pytest.mark.parametrize(
    "extra",
    [["--mismatches", "2"], ["--mismatches", "3", "--lut", "4"], ["--mismatches", "2", "--rc"],
     ["--edits", "1"], ["--edits", "2", "--rc"], ["--edits", "2", "--lut", "4", "--seed-hits", "8"]],
    ids=["m2", "m3-lut", "m2-rc", "e1", "e2-rc", "e2-lut-cap"],
)
def test_locate_approx_pos_byte_identical(tmp_path, ref, capsys, extra):
    """``locate --mismatches m >= 2`` and ``--edits E`` (30 bp reads with two
    planted substitutions or edits) write tpufm's .pos bytes, plus .pos.rc
    with --rc, which expands before the approximate pass as tpufm's does."""
    codes, fa = ref
    reads, starts = _mutated_reads(codes, 30, 40, seed=len(extra), kind="edit" if "--edits" in extra else "sub")
    qry = tmp_path / "q.qry"
    write_reads_fasta(qry, reads, starts)
    args = ["locate", str(fa), "3000", str(qry), "30", "40", "--k", "2", "--d", "64",
            "--sample-rate", "8", "--max-hits", "6", *extra]
    jax_cli.main(args + ["--output", str(tmp_path / "jax.pos")])
    run = torch_cli.main(args + ["--device", "cpu", "--output", str(tmp_path / "torch.pos")])
    suffixes = ["", ".rc"] if "--rc" in extra else [""]
    for suffix in suffixes:
        assert (tmp_path / f"torch.pos{suffix}").read_bytes() == (tmp_path / f"jax.pos{suffix}").read_bytes()
    assert run.positions.shape == (40 * len(suffixes), 6) and run.intervals is None
    assert run.counts.shape == run.overflow.shape == (40 * len(suffixes),)
    if "--mismatches" in extra:  # every origin is a site (not so under edits: the leftmost start wins)
        for line, s in zip(_pos_lines(tmp_path / "torch.pos"), starts):
            assert int(s) in line
    out = capsys.readouterr().out
    assert out.count("40 queries, max 6 hits each") == 2
    assert out.count("seed-hits=8 cap") in (0, 2)


def _pairs_files(tmp_path, codes, n, seed):
    from tpufm.io.genreads import generate_read_pairs

    r1, r2 = generate_read_pairs(codes, 30, n, 100, 400, seed=seed)
    r1 = np.array(r1)
    r1[::3, 11] = (r1[::3, 11] + 1) % 4  # a substitution in a third of the R1 mates
    write_reads_fasta(tmp_path / "r1.qry", r1)
    write_reads_fasta(tmp_path / "r2.qry", r2)
    return tmp_path / "r1.qry", tmp_path / "r2.qry"


@pytest.mark.parametrize(
    "extra",
    [[], ["--mismatches", "1"], ["--mismatches", "2"], ["--edits", "1"], ["--lut", "4", "--max-pairs", "2"]],
    ids=["exact", "m1", "m2", "e1", "lut-max-pairs"],
)
def test_locate_paired_byte_identical(tmp_path, ref, capsys, extra):
    """``locate --paired R2`` writes tpufm's <queries>.pairs bytes (one line a
    pair of reads, ``left:right:strand`` tokens) with each position source."""
    codes, fa = ref
    r1, r2 = _pairs_files(tmp_path, codes, 32, seed=len(extra))
    args = ["locate", str(fa), "3000", str(r1), "30", "32", "--k", "2", "--d", "64", "--sample-rate", "8",
            "--paired", str(r2), "--insert-min", "100", "--insert-max", "400", *extra]
    jax_cli.main(args + ["--output", str(tmp_path / "jax.pairs")])
    run = torch_cli.main(args + ["--device", "cpu"])
    assert (tmp_path / "r1.qry.pairs").read_bytes() == (tmp_path / "jax.pairs").read_bytes()
    assert run.pairs.shape[:2] == run.strand.shape == (32, 2 if "--max-pairs" in extra else 4)
    exact = not extra or extra[0] == "--lut"
    assert (run.counts > 0).sum() >= (21 if exact else 32)  # the unmutated pairs at least
    out = capsys.readouterr().out
    assert out.count("32 read pairs, ") == 2


@pytest.mark.parametrize("extra", [["--mismatches", "2"], ["--edits", "1"], ["--paired", "R2", "--edits", "1"]],
                         ids=["m2", "e1", "paired-e1"])
def test_locate_approx_from_store(tmp_path, ref, extra):
    """With --from-store the verify pass reads the text from the reference
    FASTA (the same positions as a build from it); with no FASTA there, the
    port exits with tpufm's message."""
    codes, fa = ref
    r1, r2 = _pairs_files(tmp_path, codes, 16, seed=3)
    extra = [str(r2) if x == "R2" else x for x in extra]
    tail = [str(r1), "30", "16", "--k", "2", "--d", "64", "--sample-rate", "8", *extra]
    jax_cli.main(["locate", str(fa), "3000", *tail, "--store", str(tmp_path / "P"),
                  "--output", str(tmp_path / "built")])
    torch_cli.main(["locate", str(fa), "3000", *tail, "--from-store", str(tmp_path / "P"),
                    "--output", str(tmp_path / "loaded"), "--device", "cpu"])
    assert (tmp_path / "loaded").read_bytes() == (tmp_path / "built").read_bytes()
    codes_ = []
    for main, dev in ((jax_cli.main, []), (torch_cli.main, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as exit_info:
            main(["locate", "-", "0", *tail, "--from-store", str(tmp_path / "P"), *dev])
        codes_.append(exit_info.value.code)
    assert codes_[0] == codes_[1] and "reference FASTA" in codes_[1]


@pytest.mark.parametrize(
    "extra",
    [["--edits", "1", "--mismatches", "1"], ["--mismatches", "-1"], ["--paired", "R2", "--rc"]],
    ids=["two-models", "negative", "paired-rc"],
)
def test_locate_approx_errors_as_tpufm(tmp_path, ref, extra):
    codes, fa = ref
    r1, r2 = _pairs_files(tmp_path, codes, 4, seed=1)
    extra = [str(r2) if x == "R2" else x for x in extra]
    args = ["locate", str(fa), "3000", str(r1), "30", "4", "--k", "2", "--d", "64", *extra]
    with pytest.raises(SystemExit) as theirs:
        jax_cli.main(args)
    with pytest.raises(SystemExit) as ours:
        torch_cli.main(args + ["--device", "cpu"])
    assert isinstance(ours.value.code, str) and ours.value.code == theirs.value.code


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


def _tree_bytes(path):
    """{relative name: bytes} of a file, or of every file under a directory
    (a .tpufm store)."""
    if path.is_dir():
        return {str(p.relative_to(path)): p.read_bytes() for p in sorted(path.rglob("*")) if p.is_file()}
    return {"": path.read_bytes()}


@pytest.mark.parametrize(
    "output,extra",
    [(None, []), (None, ["--auto", "--tail", "--save-ref"]), ("ref.npz", ["--tail"]),
     ("ref.tpufm", ["--auto", "--save-ref"]), ("ref.fmi", ["--k", "1", "--d", "32", "--tail"]),
     ("ref.npz", ["--k", "3", "--d", "96", "--sa", "doubling"])],
    ids=["default-name", "auto-tail-save-ref", "npz-tail", "tpufm-auto", "k1-tail", "npz-doubling"],
)
def test_build_byte_identical(tmp_path, monkeypatch, capsys, output, extra):
    """``build`` writes tpufm's index file (.fmi by the reference's default
    name, .npz, .tpufm), its .tail.npz and the re-emitted reference byte for
    byte; the zip members of an .npz carry the write time, so the clock is
    held still for both writers."""
    import time

    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    codes = np.random.default_rng(4).integers(0, 4, size=3000, dtype=np.uint8)
    outs = {}
    for name, main in (("jax", jax_cli.main), ("torch", torch_cli.main)):
        d = tmp_path / name
        d.mkdir()
        write_reference(d / "ref.fa", decode_bases(codes))
        args = ["build", str(d / "ref.fa"), "3000", *extra]
        if output:
            args += ["--output", str(d / output)]
        run = main(args)
        outs[name] = {str(p.relative_to(d)): _tree_bytes(p) for p in sorted(d.iterdir())}
    assert outs["torch"] == outs["jax"]
    names = set(outs["torch"])
    assert ("ref.fa.3000.fa" in names) == ("--save-ref" in extra)
    assert any(n.endswith(".tail.npz") for n in names) == ("--tail" in extra)
    default = "ref.fa.3000.192fmi3steps.fmi" if "--auto" in extra else "ref.fa.3000.64fmi2steps.fmi"
    assert run.output.endswith(output or default)
    out = capsys.readouterr().out
    assert out.count("auto config: k=3 d=192 (recommend lut_m=12)") == (2 if "--auto" in extra else 0)


@pytest.mark.parametrize("extra", [[], ["--seed", "9", "--output", "reads.qry"],
                                   ["--paired"], ["--paired", "--insert-min", "40", "--insert-max", "90",
                                                  "--output", "pairs.qry"]],
                         ids=["single", "single-seed", "paired", "paired-insert"])
def test_genreads_byte_identical(tmp_path, monkeypatch, extra):
    codes = np.random.default_rng(6).integers(0, 4, size=3000, dtype=np.uint8)
    outs = {}
    for name, main in (("jax", jax_cli.main), ("torch", torch_cli.main)):
        d = tmp_path / name
        d.mkdir()
        write_reference(d / "ref.fa", decode_bases(codes))
        monkeypatch.chdir(d)
        main(["genreads", "ref.fa", "3000", "30", "50", *extra])
        outs[name] = {p.name: p.read_bytes() for p in sorted(d.iterdir())}
    assert outs["torch"] == outs["jax"]
    assert len(outs["torch"]) == (3 if "--paired" in extra else 2)


def _bench_args(main, monkeypatch, module, argv):
    """The parsed arguments ``bench`` would run with."""
    seen = []
    monkeypatch.setattr(module, "cmd_bench", seen.append)
    main(["bench", *argv])
    args = vars(seen[0])
    args.pop("fn")
    return args


@pytest.mark.parametrize("argv", [[], ["--genome", "--lut", "0", "--locate", "--fused", "--mesh", "1"]])
def test_bench_parser_equals_tpufm(monkeypatch, argv):
    want = _bench_args(jax_cli.main, monkeypatch, jax_cli, argv)
    got = _bench_args(torch_cli.main, monkeypatch, torch_cli, argv)
    assert got.pop("device") == "cuda"
    assert got.pop("trace") is None  # the port's own --trace DIR, before any command
    assert got == want


def test_bench_prints_one_json_line(capsys):
    import json

    record = torch_cli.main(["bench", "--refsize", "20000", "--numqueries", "256", "--length", "24",
                             "--lut", "4", "--iterations", "1", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == record
    assert record["metric"] == ("k-step backward-search steps/s/chip (k=2, d=64, 256 reads x 24 bp, "
                                "engine=xla)")
    detail = record["detail"]
    assert detail["bit_exact_vs_oracle"] and detail["bit_exact_vs_plain_full"]
    assert detail["device"] == "cpu" and detail["verified_reads"] == 256


def test_bench_needs_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        torch_cli.main(["bench", "--refsize", "1000", "--numqueries", "8", "--length", "24"])


#: a small mesh bench record: 8 CPU shards
MESH_BENCH = ["--mesh", "8", "--refsize", "20000", "--numqueries", "256", "--length", "24", "--k", "2", "--d", "64",
              "--lut", "4", "--iterations", "1"]


@pytest.mark.parametrize(
    "argv,item",
    [(["bench", "--sharded", *MESH_BENCH], "ported"),
     (["bench", "--multichip", *MESH_BENCH], "ported"),
     (["bench", "--locate", "--mesh", "4", "--refsize", "20000", "--numqueries", "1001", "--iterations", "1"],
      "ported"),
     (["build", "REF", "100", "--on-device"], None), (["build", "REF", "100", "--sa", "device"], None),
     (["build", "REF", "100", "--mesh", "2"], "exit"), (["build", "REF", "100", "--store-sharded"], "exit"),
     (["build", "REF", "100", "--sa", "sharded"], None)],
    ids=["sharded", "multichip", "locate-mesh", "on-device",
         "sa-device", "mesh", "store-sharded", "sa-sharded"],
)
def test_unported_flags_exit_naming_their_item(tmp_path, argv, item):
    """Each flag of a module not ported yet exits naming its ROADMAP item;
    every flag here is ported now. The device build (``--on-device``, ``--sa
    device``; item 4) and the sharded sort (``--sa sharded``, item 6c) write
    tpufm's own ``build`` bytes with ``--device cpu``, and without a card
    the default cuda raises. ``build --mesh 2`` without ``--on-device`` and
    ``--store-sharded`` without ``--mesh`` (item 6c) exit with tpufm's
    texts (the sharded builds themselves: tests/test_torch_build_sharded_cli.py).
    ``bench --sharded`` and ``--multichip`` (item 6a) and ``bench --locate
    --mesh 4`` (item 6b) are ported: their records on 8 (4) CPU shards are
    bit-exact (tests/test_torch_parallel_cli.py and
    test_torch_parallel_locate_cli.py hold them field by field against
    tpufm's)."""
    if item == "ported":
        record = torch_cli.main([*argv, "--device", "cpu"])
        devices = int(argv[argv.index("--mesh") + 1])
        assert record["detail"]["devices"] == devices and record["detail"]["bit_exact_vs_oracle"] is True
        return
    if item is None:
        write_reference(tmp_path / "ref.fa", decode_bases(np.random.default_rng(5).integers(0, 4, 100, np.uint8)))
        argv = [str(tmp_path / "ref.fa") if a == "REF" else a for a in argv]
        jax_cli.main([*argv, "--output", str(tmp_path / "jax.fmi")])
        torch_cli.main([*argv, "--device", "cpu", "--output", str(tmp_path / "torch.fmi")])
        assert (tmp_path / "torch.fmi").read_bytes() == (tmp_path / "jax.fmi").read_bytes()
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="cuda"):
                torch_cli.main([*argv, "--output", str(tmp_path / "none.fmi")])
        return
    write_reference(tmp_path / "ref.fa", decode_bases(np.random.default_rng(5).integers(0, 4, 100, np.uint8)))
    argv = [str(tmp_path / "ref.fa") if a == "REF" else a for a in argv]
    with pytest.raises(SystemExit) as jax_exit:
        jax_cli.main(argv)
    with pytest.raises(SystemExit) as torch_exit:
        torch_cli.main([*argv, "--device", "cpu"])
    assert torch_exit.value.code == jax_exit.value.code and "requires --on-device" in str(jax_exit.value.code)


def test_bench_engine_not_ported_raises(capsys):
    """``bench --engine xla-ac`` raised naming Queue 1 item 5 until the
    engine variants were ported; it now prints its record, and an engine
    tpufm does not know still raises."""
    record = torch_cli.main(["bench", "--engine", "xla-ac", "--refsize", "5000", "--numqueries", "64",
                             "--length", "24", "--iterations", "1", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == record
    assert record["metric"].endswith("engine=xla-ac)") and record["detail"]["bit_exact_vs_oracle"]
    with pytest.raises(ValueError, match="unknown engine 'tpu'"):
        torch_cli.main(["bench", "--engine", "tpu", "--refsize", "5000", "--device", "cpu"])


@pytest.mark.parametrize(
    "argv,metric",
    [(["--mismatches", "2"], "seed-extend locate reads/s (m=2, k=2, d=64, lut=4, s=8, seed_hits=32, "
                             "64 x 30 bp, 20000 bases)"),
     (["--edits", "1"], "edit-distance locate reads/s (E=1, k=2, d=64, lut=4, s=8, seed_hits=32, "
                        "64 x 30 bp, 20000 bases)"),
     (["--paired", "--insert-min", "60", "--insert-max", "200"],
      "paired-end placement pairs/s (k=2, d=64, lut=4, insert [60, 200], 64 x 2 x 30 bp, 20000 bases)")],
    ids=["seed", "edit", "paired"],
)
def test_bench_approx_modes_print_their_record(capsys, argv, metric):
    """``bench --mismatches 2 | --edits 1 | --paired`` dispatch as tpufm's
    does and print the record as one JSON line."""
    import json

    record = torch_cli.main(["bench", "--refsize", "20000", "--numqueries", "64", "--length", "30",
                             "--lut", "4", "--sample-rate", "8", "--iterations", "1", *argv, "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == record
    assert record["metric"] == metric and record["detail"]["device"] == "cpu"
    checks = [v for key, v in record["detail"].items()
              if key.startswith("bit_exact") or key in ("sound_vs_dp_oracle", "origin_recovered_sample")]
    assert checks and all(v is True for v in checks)


@pytest.mark.parametrize("argv", [["--edits", "1", "--locate"], ["--mismatches", "2", "--sharded"],
                                  ["--paired", "--edits", "1"]])
def test_bench_approx_mode_conflicts_exit_as_tpufm(argv):
    with pytest.raises(SystemExit) as theirs:
        jax_cli.main(["bench", *argv])
    with pytest.raises(SystemExit) as ours:
        torch_cli.main(["bench", *argv, "--device", "cpu"])
    assert ours.value.code == theirs.value.code
