"""The port and its smoke script stand alone: a child interpreter blocks every
import of jax and of the JAX package tpufm, then imports tpufm_torch, its
CLI, its kernel loader, every engine module, the device build
(tpufm_torch.index) and chip_smoke, builds an index and locate tables with
the port's own host side and again with the device build on the CPU (the
same arrays), runs a small CPU search on
both gather paths, a variable-length one, a fused search+locate, a
Hamming <= 1 count, a seed-and-extend locate at two substitutions, an
edit-distance locate, a paired placement and a small ``align --bam`` on a
two-record reference (its SAM, BAM and contig-map modules imported), then
``sort`` and ``view REGION`` on that BAM, ``faidx`` of the reference,
``transform`` and a search of its alternate-counters image, and a
``search --resume`` crashed after one wave and resumed (the SAM/BAM tools,
faidx, layout and stream modules imported), and a search over 4 CPU shards
through the mesh engines (tpufm_torch.parallel: data-parallel, and the
sharded index with the allgather and a2a routings), the sharded build of
the index and the locate tables over those shards and a per-shard store
written, read back and searched (tpufm_torch.index.builder_sharded,
tpufm_torch.profiling imported), a one-process gloo group of world size 1
started through ``initialize_distributed`` and a search over its mesh,
and checks them against the port's numpy oracles, naive scans of the text and
each read's origin; the parent holds the result against tpufm's builder
and oracle.
chip_smoke itself refuses to run without a GPU, or without the repo around
it. Intervals are integers and compare exactly (tolerance 0)."""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tpufm.config import IndexConfig
from tpufm.engine.oracle import search_oracle
from tpufm.index.builder import build_index

REPO = Path(__file__).resolve().parent.parent

CHILD = r"""
import json, sys

class Blocked:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "tpufm"):
            raise ImportError(f"blocked here: {name}")
        return None

sys.meta_path.insert(0, Blocked())

import numpy as np
import chip_smoke
import tpufm_torch, tpufm_torch.cli, tpufm_torch.kernels
import tpufm_torch.engine.lf_round, tpufm_torch.engine.row_gather
import tpufm_torch.engine.locate, tpufm_torch.engine.mismatch
import tpufm_torch.engine.seed, tpufm_torch.engine.edit, tpufm_torch.engine.paired
from tpufm_torch.engine.edit import EditExtendEngine, windowed_edit_dist
from tpufm_torch.engine.paired import PairedEndEngine, pair_oracle
from tpufm_torch.engine.seed import SeedExtendEngine, seed_extend_oracle
from tpufm_torch import SearchEngine
from tpufm_torch.engine.search_locate import SearchLocateEngine
from tpufm_torch.host.index import IndexConfig, build_index, derive_tail
from tpufm_torch.host.locate import build_locate, locate_hits
from tpufm_torch.host.oracle import search_oracle
from tpufm_torch.host.suffix_array import suffix_array

rng = np.random.default_rng(7)
codes = rng.integers(0, 4, size=1000, dtype=np.uint8)
index = build_index(codes, IndexConfig(k=3, d=64), sa_method=sys.argv[1])
starts = rng.integers(0, 976, size=20)
queries = np.stack([codes[s : s + 24] for s in starts])
res = SearchEngine(index, "cpu", lut_m=6).search(queries)
assert np.array_equal(res, search_oracle(index, queries))
assert np.array_equal(SearchEngine(index, "cpu", lut_m=6, gather="dma").search(queries), res)
tail = derive_tail(index)
batch = queries.copy()
batch[:, :5] = 0xFF  # 19 bp reads, right-aligned
got = SearchEngine(index, "cpu", lut_m=6, tail_index=tail).search_varlen(batch)
assert np.array_equal(got, search_oracle(index, queries[:, 5:], tail_index=tail))
loc = build_locate(codes, sample_rate=8, d=64, sa=suffix_array(codes, sys.argv[1]))
import tpufm_torch.index
from tpufm_torch.index.builder_device import build_index_device, build_locate_device
dev_index = build_index_device(codes, IndexConfig(k=3, d=64), device="cpu")  # the device build, here on the CPU
assert all(np.array_equal(getattr(dev_index, f), getattr(index, f))
           for f in ("occ", "bitmaps", "dollar_pos", "dollar_base"))
dev_loc = build_locate_device(codes, sample_rate=8, d=64, device="cpu")
assert all(np.array_equal(getattr(dev_loc, f), getattr(loc, f)) for f in ("samples", "mark_words", "mark_rank"))
iv, pos = SearchLocateEngine(index, loc, "cpu", max_hits=4, lut_m=6).search_locate(queries[:, 1:])
assert np.array_equal(iv, search_oracle(index, queries[:, 1:], tail_index=loc.lf1))  # 23 % 3: tail
assert np.array_equal(pos, locate_hits(loc, iv, 4))
wins = np.lib.stride_tricks.sliding_window_view(codes, 24)
mm = SearchEngine(index, "cpu", lut_m=6).count(queries, mismatches=1, wave=7)
assert np.array_equal(mm, ((wins[None] != queries[:, None]).sum(2) <= 1).sum(1))
sub = queries.copy()
sub[:, [3, 17]] = (sub[:, [3, 17]] + 1) % 4  # two substitutions a read
pos, cnt, ovf = SeedExtendEngine(index, loc, codes, mismatches=2, max_hits=8, device="cpu").locate_approx(sub)
want_cnt, want_pos = seed_extend_oracle(codes, sub, 2)
assert np.array_equal(cnt, want_cnt) and not ovf.any()
assert all(np.array_equal(r[r != 0xFFFFFFFF], w[:8]) for r, w in zip(pos, want_pos))
ind = np.concatenate([queries[:, :10], queries[:, 11:], codes[starts + 24, None]], axis=1)  # a deletion
sites, _, ovf = EditExtendEngine(index, loc, codes, edits=1, device="cpu").locate_edits(ind)
import torch
ct = torch.from_numpy(codes)
for read, row in zip(ind, sites):
    got = row[row != 0xFFFFFFFF].astype(np.int64)
    assert got.size and (windowed_edit_dist(ct, torch.from_numpy(np.repeat(read[None], got.size, 0)),
                                            torch.from_numpy(got), 1) <= 1).all()
left = starts[:8] % 800  # fragments of 170 bases: R1 its head, R2 its tail reverse-complemented
r1 = codes[left[:, None] + np.arange(20)]
r2 = (3 - codes[left[:, None] + 150 + np.arange(20)][:, ::-1]).astype(np.uint8)
pairs, strand, counts, _ = PairedEndEngine(index, loc, 0, 400, device="cpu").pair(r1, r2)
want = pair_oracle(codes, r1, r2, 0, 400)
assert [int(c) for c in counts] == [len(w) for w in want] and all(c >= 1 for c in counts)
import os, tempfile
import tpufm_torch.host.align, tpufm_torch.host.contigs, tpufm_torch.host.sam
from tpufm_torch.host.bam import read_bam
from tpufm_torch.host.seqio import decode_bases
with tempfile.TemporaryDirectory() as d:  # align, two records, 24 bp FASTQ reads, BAM out
    fa, fq, out = (os.path.join(d, x) for x in ("g.fa", "r.fq", "r.bam"))
    with open(fa, "wb") as fp:
        fp.write(b">c1\n" + decode_bases(codes[:600]) + b"\n>c2\n" + decode_bases(codes[600:]) + b"\n")
    with open(fq, "w") as fp:
        fp.write("".join(f"@a{i}\n{decode_bases(q).decode()}\n+\n{'I' * 24}\n" for i, q in enumerate(queries)))
    tpufm_torch.cli.main(["align", fa, fq, "--sample-rate", "8", "--bam", "-o", out, "--device", "cpu"])
    header, records = read_bam(out)
    primary = {r[0]: r for r in records if not int(r[1]) & 0x100}
    for i, s in enumerate(starts):
        if s + 24 <= 600 or s >= 600:  # inside one record: placed at its origin
            assert primary[f"a{i}"][1:4] == ["0", "c1" if s < 600 else "c2", str(s + 1 - 600 * (s >= 600))]
    assert header.count("@SQ") == 2
    import contextlib, io
    import tpufm_torch.tools, tpufm_torch.host.bam_index, tpufm_torch.host.faidx
    import tpufm_torch.host.layouts, tpufm_torch.host.stream
    from tpufm_torch.host.formats import read_fmi, write_fmi
    from tpufm_torch.host.seqio import write_reads_fasta

    def cli_out(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            run = tpufm_torch.cli.main(argv)
        return run, buf.getvalue()

    srt = os.path.join(d, "s.bam")  # sort, then a region through the .bai
    cli_out(["sort", out, "--output", srt])
    assert os.path.exists(srt + ".bai")
    region = [x.split("\t") for x in cli_out(["view", srt, "c1:100-300", "--no-header"])[1].splitlines()]
    want = [r for r in records if r[2] == "c1" and int(r[3]) <= 300 and int(r[3]) + 23 >= 100]
    assert sorted(region) == sorted(want) and region
    _, fa_out = cli_out(["faidx", fa, "c2:5-30"])  # faidx
    assert fa_out == ">c2:5-30\n" + decode_bases(codes[604:630]).decode() + "\n"
    fmi = os.path.join(d, "i.fmi")  # transform, then a search of its alternate-counters image
    write_fmi(fmi, index)
    cli_out(["transform", fmi])
    qry, rres = os.path.join(d, "q.qry"), os.path.join(d, "q.res")
    write_reads_fasta(qry, queries)
    # the .ac image on its slim counters (no LUT: tpufm refuses one there)
    run, _ = cli_out(["search", fmi + ".ac", qry, "24", "20", "--engine", "xla-ac", "--iterations", "1",
                      "--device", "cpu", "--output", os.path.join(d, "ac.res")])
    assert run.engine.alt_counters and np.array_equal(run.results, res)
    import tpufm_torch.sweep  # a tiny sweep: every engine, with and without a LUT
    rows, _ = cli_out(["sweep", "--refsizes", "3000", "--ks", "3", "--ds", "64", "--engines",
                       *tpufm_torch.sweep.SWEEP_ENGINES, "--luts", "0", "6", "--numqueries", "32",
                       "--length", "24", "--iterations", "1", "--device", "cpu"])
    assert len(rows) == 8 and all(r["bit_exact"] for r in rows)
    # search --resume, crashed, then resumed
    SearchEngine.WAVE = 8
    real, left = SearchEngine.search, [1]

    def crashing(self, *a, **kw):
        if not left[0]:
            raise RuntimeError("simulated crash")
        left[0] -= 1
        return real(self, *a, **kw)

    SearchEngine.search = crashing
    try:
        cli_out(["search", fmi, qry, "24", "20", "--resume", "--device", "cpu", "--output", rres])
        raise AssertionError("no crash")
    except RuntimeError:
        pass
    SearchEngine.search = real
    assert os.path.exists(rres + ".progress")
    run, _ = cli_out(["search", fmi, qry, "24", "20", "--resume", "--device", "cpu", "--output", rres])
    assert np.array_equal(run.results, search_oracle(index, queries)) and not os.path.exists(rres + ".partial")
import tpufm_torch.parallel  # the mesh engines: 4 CPU shards, the index replicated and split
from tpufm_torch.parallel import DataParallelEngine, ShardedIndexEngine, make_mesh
mesh4 = make_mesh(4, device="cpu")
want = search_oracle(index, queries)
assert np.array_equal(DataParallelEngine(index, mesh4, lut_m=6).search(queries), want)
for routing in ("allgather", "a2a"):
    assert np.array_equal(ShardedIndexEngine(index, mesh4, routing=routing, lut_m=6).search(queries), want)
import tpufm_torch.profiling  # the sharded build over the 4 CPU shards, and a per-shard store's round trip
from tpufm_torch.host.formats import load_store_sharded, save_store_sharded
from tpufm_torch.index.builder_sharded import build_index_sharded, build_locate_sharded
sharded = build_index_sharded(codes, IndexConfig(k=3, d=64), mesh4)
assert all(np.array_equal(getattr(sharded, f), getattr(index, f)) for f in ("occ", "bitmaps", "dollar_pos", "dollar_base"))
sloc = build_locate_sharded(codes, sample_rate=8, d=64, mesh=mesh4)
assert all(np.array_equal(getattr(sloc, f), getattr(loc, f)) for f in ("samples", "mark_words", "mark_rank"))
with tempfile.TemporaryDirectory() as d:
    tables = build_index_sharded(codes, IndexConfig(k=3, d=64), mesh4, return_host=False)
    back = load_store_sharded(save_store_sharded(os.path.join(d, "s.tpufm"), tables), mesh4)
    assert np.array_equal(ShardedIndexEngine(back, mesh4, lut_m=6).search(queries), want)
# a one-process gloo group of world size 1, and a search over its mesh; port 0:
# its store listens on a port the system picks (no peer needs to know it)
from tpufm_torch.parallel import initialize_distributed, shutdown_distributed
initialize_distributed("127.0.0.1:0", num_processes=1, process_id=0, backend="gloo", timeout=60)
group_mesh = make_mesh(2, device="cpu")
assert (group_mesh.size, group_mesh.process_count, group_mesh.local_shards) == (2, 1, (0, 1))
assert np.array_equal(ShardedIndexEngine(index, group_mesh, routing="ring", lut_m=6).search(queries), want)
assert np.array_equal(DataParallelEngine(index, group_mesh).search(queries), want)
shutdown_distributed()
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "tpufm")]
print(json.dumps(res.tolist()))
"""


def _run(args, cwd, timeout=300):
    env = {**os.environ, "PYTHONPATH": str(cwd)}
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=timeout,
    )


@pytest.mark.parametrize("sa_method", ["native", "doubling"])
def test_port_imports_and_searches_without_jax_or_tpufm(sa_method):
    proc = _run(["-c", CHILD, sa_method], REPO)
    assert proc.returncode == 0, proc.stderr
    got = np.asarray(json.loads(proc.stdout.splitlines()[-1]), dtype=np.uint32)

    rng = np.random.default_rng(7)
    codes = rng.integers(0, 4, size=1000, dtype=np.uint8)
    index = build_index(codes, IndexConfig(k=3, d=64), sa_method="doubling")
    queries = np.stack([codes[s : s + 24] for s in rng.integers(0, 976, size=20)])
    np.testing.assert_array_equal(got, search_oracle(index, queries))


def test_package_sources_never_import_jax_or_tpufm():
    banned = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|tpufm)\b", re.M)
    for path in [*(REPO / "tpufm_torch").rglob("*.py"), REPO / "chip_smoke.py",
                 *(REPO / "tests").glob("torch_distworker*.py")]:
        assert not banned.search(path.read_text()), path


def test_chip_smoke_fails_without_gpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke would run for real")
    proc = _run(["chip_smoke.py"], REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    proc = _run(["chip_smoke.py"], tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.parametrize("pairs", [False, True])
def test_chip_smoke_k1_bound_counts_the_words_ends_need(pairs, monkeypatch):
    """K1's bound reads, of each distinct row, the plane words of the most
    windows an end of that row covers and each distinct (row, code) counter:
    held against a loop over the ends."""
    import torch

    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke

    k, d, nrows = 2, 64, 7
    rng = np.random.default_rng(5)
    n = 40
    iv = rng.integers(0, d * nrows + 20, size=(n, 2) if pairs else n)
    code = rng.integers(0, 64, size=n)
    windows, counters = {}, set()
    for end, c in zip(iv.reshape(-1), np.repeat(code, 2) if pairs else code):
        row = min(end // d, nrows - 1)
        windows[row] = max(windows.get(row, 0), -(-(end % d) // 32))
        counters.add((row, c % 4**k))
    want = 4 * (2 * k * sum(windows.values()) + len(counters))
    got = chip_smoke.k1_table_bytes(torch.from_numpy(iv), torch.from_numpy(code), k, d, nrows)
    assert got == want
