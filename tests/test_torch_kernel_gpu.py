"""The port's CUDA kernels on the card (marker ``gpu``; skips without one).

It imports neither jax nor tpufm, so that it runs on a machine with a GPU
and no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_kernel_gpu.py

The LF round kernel (all three entries: per read, per end on its own rows,
and on rows gathered beforehand; on host-width rows, which take its word
path where they are not 16-byte aligned, and on the engines' device rows,
padded to a multiple of 4 words), the row gather kernel (both copy paths,
16-byte units and words, on aligned and offset tables and outputs; row
counts at, around and past its tile and its persistent grid; clamped
indices) and the locate walk kernel (lane refill across warps holding
walks of 0 and sample_rate - 1 hops) must equal their
plain PyTorch versions on the same CUDA tensors, and the engine's searches
on the card
(fixed length on both gather paths, and variable length), its fused
search+locate and its Hamming <= 1 locate must equal the plain path and the
numpy oracle. The seed-and-extend Hamming verify kernel (K5) and the Myers
verifier (K6: registers for reads up to 256 bp, the scratch buffer past
them) must equal their plain versions on windows at every 16-base offset,
the last valid start, windows past the text end and invalid lanes, and
their tile compaction (2048 lanes a block) on grids with every lane valid,
none, one at the last slot of each tile, a ragged end, fewer lanes than a
tile, a read wider than a tile and a mask off its 16-byte boundary; the seed,
edit and paired engines on the card must equal their plain path and their
oracles, and the mesh locate over two shards of one card the one-device
engines. The table-building kernel (K7) must equal its plain version at k
1-8 on edge sizes and texts, and on each shard's rows of a four-shard
split, as must the pack of its text; the whole device build the host
builders, and the sharded build over two shards of one card the one-device
build.
Intervals, positions, distances and table words are integers and compare
exactly (tolerance 0).
"""

import functools

import numpy as np
import pytest
import torch

from tpufm_torch import SearchEngine
from tpufm_torch.engine import edit as edit_mod
from tpufm_torch.engine import lf_round as lf_mod
from tpufm_torch.engine import locate as loc_mod
from tpufm_torch.engine import row_gather as rg_mod
from tpufm_torch.engine import seed as seed_mod
from tpufm_torch.engine.paired import PairedEndEngine, pair_oracle
from tpufm_torch.engine.search import _rows
from tpufm_torch.engine.search_locate import SearchLocateEngine
from tpufm_torch.engine.tables import build_paired_entries, tables_from_index
from tpufm_torch.host.layouts import make_alt_counters
from tpufm_torch.host.index import IndexConfig, build_index, derive_tail
from tpufm_torch.host.locate import build_locate, locate_hits
from tpufm_torch.host.oracle import search_oracle
from tpufm_torch.host.suffix_array import suffix_array

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the port's kernels have no CPU mode")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def _index(k, d, n, seed=11):
    codes = np.random.default_rng(seed).integers(0, 4, size=n, dtype=np.uint8)
    return codes, build_index(codes, IndexConfig(k=k, d=d), sa_method="doubling")


def _ends(rng, bwtsize, d, n):
    """Seeded ends over [0, bwtsize] and the same as reads (lo, hi): half of
    the reads with both ends in one block, half across blocks; the first
    end and read end at bwtsize (an aligned text: the sentinel row)."""
    iv = rng.integers(0, bwtsize + 1, size=n)
    iv[0] = bwtsize
    inside = np.minimum(iv - iv % d + rng.integers(0, d, size=n), bwtsize)
    other = np.where(np.arange(n) % 2 == 0, inside, rng.integers(0, bwtsize + 1, size=n))
    pairs = np.sort(np.stack([iv, other], axis=1), axis=1)
    return iv, pairs


def _check_k1(cuda, table, dollar, bwtsize, k, d, n):
    """All three K1 entries on ``table`` (uint32 rows) against their plain
    versions: n ends, n reads, n gathered rows."""
    rng = np.random.default_rng(n + 31 * k + d + table.shape[1])
    iv, pairs = _ends(rng, bwtsize, d, n)
    code = rng.integers(0, 4**k, size=n)
    entries, iv, pairs, code, dollar = (
        torch.from_numpy(a).to(cuda)
        for a in (np.ascontiguousarray(table).view(np.int32), iv, pairs, code, dollar.astype(np.int64))
    )
    before = lf_mod.LAUNCHES, lf_mod.PAIRS_LAUNCHES, lf_mod.ROWS_LAUNCHES
    got = lf_mod.lf_round(entries, iv, code, dollar, k, d)
    got_pairs = lf_mod.lf_round_pairs(entries, pairs, code, dollar, k, d)
    rows = rg_mod.row_gather_reference(entries, iv // d)
    got_rows = lf_mod.lf_round_rows(rows, iv, code, dollar, k, d)
    torch.cuda.synchronize()
    assert (lf_mod.LAUNCHES, lf_mod.PAIRS_LAUNCHES, lf_mod.ROWS_LAUNCHES) == tuple(b + 1 for b in before)
    want = lf_mod.lf_round_reference(entries, iv, code, dollar, k, d)
    assert torch.equal(got, want)
    assert torch.equal(got_rows, want)
    assert torch.equal(got_pairs, lf_mod.lf_round_pairs_reference(entries, pairs, code, dollar, k, d))


@pytest.mark.parametrize("n", [1, 31, 4099])
@pytest.mark.parametrize("width", ["host", "device"])
# host widths stage 16-byte units where the row stride is a multiple of 4
# words, else words; k=8 d=960 stages more than 48 KB a warp
@pytest.mark.parametrize("k,d", [(k, d) for k in (1, 2, 3, 4) for d in (32, 64, 128, 192, 448)] + [(8, 960)])
def test_lf_round_kernel_matches_plain(cuda, k, d, width, n):
    # a text of c*d - 1 bases: bwtsize % d == 0, so bwtsize reads the sentinel row
    _, index = _index(k, d, 7 * d - 1)
    t = tables_from_index(index)
    table = t.entries if width == "host" else _rows(t.entries, torch.device("cpu")).numpy().view(np.uint32)
    _check_k1(cuda, table, t.dollar, index.bwtsize, k, d, n)


@pytest.mark.parametrize("n", [1, 31, 4099])
@pytest.mark.parametrize("width", ["host", "device"])
@pytest.mark.parametrize("d", [32, 192])
def test_lf_round_kernel_on_locate_rows(cuda, d, width, n):
    """The locate rows as the k=1 table (the search's tail in the fused
    locate): 3*nb + 5 words, 23 at d=192, or 24 as the engines pad them."""
    codes = np.random.default_rng(d).integers(0, 4, size=7 * d - 1, dtype=np.uint8)
    t = loc_mod.locate_tables_from_index(build_locate(codes, sample_rate=8, d=d, sa=suffix_array(codes, "doubling")))
    table = t.rows if width == "host" else _rows(t.rows, torch.device("cpu")).numpy().view(np.uint32)
    _check_k1(cuda, table, t.dollar, codes.shape[0] + 1, 1, d, n)


def _gather_rows(cuda, n: str, W: int, path: str) -> int:
    """The row count named by ``n``: a number, or one about the tile T of
    the copy ``path`` takes at width W ("T-1", "T", "T+1"), or "wrap": more
    rows than the persistent grid copies in one round of tiles."""
    if n.isdigit():
        return int(n)
    p = rg_mod.plan(1 << 40, W, 0 if path != "words" else 4, 0 if path != "out+4" else 4, rg_mod._sms(cuda))
    return {"T-1": p.tile_rows - 1, "T": p.tile_rows, "T+1": p.tile_rows + 1,
            "wrap": p.blocks * p.tile_rows + p.tile_rows + 1}[n] or 1


@pytest.mark.parametrize("E", [1000, 1])
# vector: table and out 16-byte aligned; words: the table 4 B past a 16-byte
# boundary; out+4: the output 4 B past one
@pytest.mark.parametrize("path", ["vector", "words", "out+4"])
# below one 16-byte unit, the word path's 6, the search's 100, and 200 (not
# a power of two, above 128)
@pytest.mark.parametrize("W", [1, 3, 6, 8, 100, 128, 200])
@pytest.mark.parametrize("n", ["1", "31", "T-1", "T", "T+1", "4099", "wrap"])
def test_row_gather_kernel_matches_plain(cuda, n, W, path, E):
    n = _gather_rows(cuda, n, W, path)
    rng = np.random.default_rng(n * W + E)
    # one word of slack: the "words" table starts 4 B past a 16-byte boundary
    flat = torch.from_numpy(rng.integers(-(2**31), 2**31, size=E * W + 1, dtype=np.int64).astype(np.int32)).to(cuda)
    table = (flat[1:] if path == "words" else flat[:-1]).view(E, W)
    idx = rng.integers(0, E, size=n)
    idx[: min(n, 4)] = [E + 5, E, -1, 2**31 + 7][: min(n, 4)]  # clamped into the table
    idx = torch.from_numpy(idx).to(cuda)
    buf = torch.empty(n * W + 1, dtype=torch.int32, device=cuda)
    out = (buf[1:] if path == "out+4" else buf[:-1]).view(n, W)
    want = "int4" if path == "vector" and W % 4 == 0 else "word"
    assert rg_mod.plan(n, W, table.data_ptr(), out.data_ptr(), rg_mod._sms(cuda)).path == want
    before = rg_mod.LAUNCHES
    got = rg_mod.row_gather(table, idx, out=out)
    torch.cuda.synchronize()
    assert got is out and rg_mod.LAUNCHES == before + 1
    assert torch.equal(got, rg_mod.row_gather_reference(table, idx))
    assert torch.equal(rg_mod.row_gather(table, idx), got)
    assert rg_mod.LAUNCHES == before + 2


@pytest.mark.parametrize("n", [1, 31, 4099])
@pytest.mark.parametrize("k,d,W", [(1, 32, 6), (3, 192, 100), (3, 192, 128)])
def test_lf_round_rows_kernel_matches_plain(cuda, k, d, W, n):
    _, index = _index(k, d, 7 * d - 1)
    rng = np.random.default_rng(n + W)
    iv = rng.integers(0, index.bwtsize + 1, size=n)
    iv[0] = index.bwtsize
    code = rng.integers(0, 4**k, size=n)
    t = tables_from_index(index)
    entries = np.zeros((t.entries.shape[0], W), dtype=np.uint32)  # W - width zero words
    entries[:, : t.entries.shape[1]] = t.entries
    entries, iv, code, dollar = (
        torch.from_numpy(a).to(cuda)
        for a in (entries.view(np.int32), iv, code, t.dollar.astype(np.int64))
    )
    rows = rg_mod.row_gather_reference(entries, iv // d)
    before = lf_mod.ROWS_LAUNCHES
    got = lf_mod.lf_round_rows(rows, iv, code, dollar, k, d)
    torch.cuda.synchronize()
    assert lf_mod.ROWS_LAUNCHES == before + 1
    assert torch.equal(got, lf_mod.lf_round_rows_reference(rows, iv, code, dollar, k, d))
    assert torch.equal(got, lf_mod.lf_round_reference(entries, iv, code, dollar, k, d))


def edge_pairs(rng, bwtsize: int, d: int, dollar_pos, n: int) -> np.ndarray:
    """int64 [*, 2] reads (lo <= hi) over [0, bwtsize]: every edge end (0,
    bwtsize, each multiple of d and its neighbours, each '$' position and its
    neighbours) with itself, the next end, the end a block on and a random
    end past it; then ``n`` random reads, half inside one block."""
    ends = [0, bwtsize] + [m + o for m in range(0, bwtsize + 1, d) for o in (-1, 0, 1)]
    ends = np.unique(np.clip(ends + [int(p) + o for p in dollar_pos for o in (-1, 0, 1)], 0, bwtsize))
    far = rng.integers(ends, bwtsize + 1)
    his = [ends, np.minimum(ends + 1, bwtsize), np.minimum(ends + d, bwtsize), far]
    edges = np.concatenate([np.stack([ends, hi], axis=1) for hi in his])
    return np.concatenate([edges, _ends(rng, bwtsize, d, n)[1]])


#: (k, d) of the layouts' kernels: k 1-4 at three widths, then k 5-8
LAYOUT_KD = [(k, d) for k in (1, 2, 3, 4) for d in (32, 64, 192)] + [(5, 64), (6, 128), (7, 256), (8, 960)]


def _layout_case(cuda, k, d, n, width):
    """(index, tables, reads [*, 2], codes, dollar) on the card for a text
    of 7d - 1 bases (bwtsize % d == 0: bwtsize reads the sentinel row, and
    the alternate counters their safety row), on host-width tables or on
    rows padded as the engine pads them."""
    _, index = _index(k, d, 7 * d - 1)
    rng = np.random.default_rng(n + 31 * k + d)
    iv = edge_pairs(rng, index.bwtsize, d, index.dollar_pos, n)
    code = rng.integers(0, 4**k, size=iv.shape[0])
    pad = (lambda a: a) if width == "host" else (lambda a: _rows(a, torch.device("cpu")).numpy().view(np.uint32))
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731
    return index, pad, put(iv), put(code), put(index_dollar(index)), put


def index_dollar(index) -> np.ndarray:
    return np.stack([index.dollar_pos, index.dollar_base, index.dollar_block]).astype(np.int64)


@pytest.mark.parametrize("n", [31, 4099])
@pytest.mark.parametrize("width", ["host", "device"])
@pytest.mark.parametrize("k,d", LAYOUT_KD)
def test_lf_round_split_kernel_matches_plain(cuda, k, d, width, n):
    index, pad, iv, code, dollar, put = _layout_case(cuda, k, d, n, width)
    t = tables_from_index(index, layout="split")
    bitmaps, occ = put(pad(t.bitmaps).view(np.int32)), put(t.occ.view(np.int32))
    before = lf_mod.SPLIT_LAUNCHES
    got = lf_mod.lf_round_split(bitmaps, occ, iv, code, dollar, k, d)
    torch.cuda.synchronize()
    assert lf_mod.SPLIT_LAUNCHES == before + 1
    assert torch.equal(got, lf_mod.lf_round_split_reference(bitmaps, occ, iv, code, dollar, k, d))
    # the same function as the fused round on the same text
    fused = put(tables_from_index(index).entries.view(np.int32))
    assert torch.equal(got, lf_mod.lf_round_pairs_reference(fused, iv, code, dollar, k, d))


@pytest.mark.parametrize("n", [31, 4099])
@pytest.mark.parametrize("width", ["host", "device"])
@pytest.mark.parametrize("k,d", LAYOUT_KD)
def test_lf_round_ac_kernel_matches_plain(cuda, k, d, width, n):
    index, pad, iv, code, dollar, put = _layout_case(cuda, k, d, n, width)
    t = tables_from_index(make_alt_counters(index), layout="split")
    bitmaps, occ_slim = put(pad(t.bitmaps).view(np.int32)), put(t.occ_slim.view(np.int32))
    before = lf_mod.AC_LAUNCHES
    got = lf_mod.lf_round_ac(bitmaps, occ_slim, iv, code, dollar, k, d)
    torch.cuda.synchronize()
    assert lf_mod.AC_LAUNCHES == before + 1
    assert torch.equal(got, lf_mod.lf_round_ac_reference(bitmaps, occ_slim, iv, code, dollar, k, d))
    fused = put(tables_from_index(index).entries.view(np.int32))
    assert torch.equal(got, lf_mod.lf_round_pairs_reference(fused, iv, code, dollar, k, d))


def _wide_reads(rng, bwtsize: int, d: int, reads: str, n: int) -> np.ndarray:
    """int64 [n, 2] reads over [0, bwtsize]: every read the full interval
    (round 1 after no LUT), or each read's hi in the block after its lo's."""
    if reads == "full":
        return np.tile(np.array([[0, bwtsize]], dtype=np.int64), (n, 1))
    lo = rng.integers(0, bwtsize - d, size=n)
    hi = np.minimum((lo // d + 1) * d + rng.integers(0, d, size=n), bwtsize)
    return np.stack([lo, hi], axis=1)


@pytest.mark.parametrize("n", [31, 33, 4099])
@pytest.mark.parametrize("width", ["host", "device"])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("reads", ["full", "adjacent"])
@pytest.mark.parametrize("entry", ["split", "ac"])
def test_lf_round_split_kernels_on_reads_across_blocks(cuda, entry, reads, k, width, n):
    """K8's entries where every read's ends lie in two blocks (both rows in
    one staging batch): every read the full interval, or the ends in
    adjacent blocks; random codes, so the AC entry counts both forward and
    back; n off a multiple of 32. Bit-identical to the plain version and to
    the fused round on the same text."""
    d = 192
    _, index = _index(k, d, 20_000)
    rng = np.random.default_rng(n + 7 * k + len(reads))
    iv = _wide_reads(rng, index.bwtsize, d, reads, n)
    code = rng.integers(0, 4**k, size=n)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731
    t = tables_from_index(index if entry == "split" else make_alt_counters(index), layout="split")
    planes = t.bitmaps if width == "host" else _rows(t.bitmaps, torch.device("cpu")).numpy().view(np.uint32)
    bitmaps = put(planes.view(np.int32))
    counters = put((t.occ if entry == "split" else t.occ_slim).view(np.int32))
    ivd, coded, dollar = put(iv), put(code), put(index_dollar(index))
    fn, plain, attr = {"split": (lf_mod.lf_round_split, lf_mod.lf_round_split_reference, "SPLIT_LAUNCHES"),
                       "ac": (lf_mod.lf_round_ac, lf_mod.lf_round_ac_reference, "AC_LAUNCHES")}[entry]
    if entry == "ac":
        S = 4**k // 2
        back = ((iv // d) % 2 == 1) ^ (code[:, None] >= S)
        assert back.any() and not back.all()
    before = getattr(lf_mod, attr)
    got = fn(bitmaps, counters, ivd, coded, dollar, k, d)
    torch.cuda.synchronize()
    assert getattr(lf_mod, attr) == before + 1
    assert torch.equal(got, plain(bitmaps, counters, ivd, coded, dollar, k, d))
    fused = put(tables_from_index(index).entries.view(np.int32))
    assert torch.equal(got, lf_mod.lf_round_pairs_reference(fused, ivd, coded, dollar, k, d))


@pytest.mark.parametrize("n", [31, 4099])
@pytest.mark.parametrize("width", ["host", "device"])
@pytest.mark.parametrize("k,d", LAYOUT_KD)
def test_lf_round_paired_kernel_matches_plain(cuda, k, d, width, n):
    """Every read, ok or not, against the plain version (the same formula:
    a read whose ends lie more than a block apart takes its hi on the first
    half); the ok reads against the fused round."""
    index, pad, iv, code, dollar, put = _layout_case(cuda, k, d, n, width)
    paired = put(build_paired_entries(pad(tables_from_index(index).entries)).view(np.int32))
    before = lf_mod.PAIRED_LAUNCHES
    got, ok = lf_mod.lf_round_paired(paired, iv, code, dollar, k, d)
    torch.cuda.synchronize()
    assert lf_mod.PAIRED_LAUNCHES == before + 1
    want, want_ok = lf_mod.lf_round_paired_reference(paired, iv, code, dollar, k, d)
    assert torch.equal(got, want) and torch.equal(ok, want_ok)
    assert bool(ok.any()) and not bool(ok.all())
    fused = put(tables_from_index(index).entries.view(np.int32))
    assert torch.equal(got[ok], lf_mod.lf_round_pairs_reference(fused, iv, code, dollar, k, d)[ok])


def _paired_reads(rng, nrows: int, d: int, pattern: str, n: int) -> np.ndarray:
    """int64 [n, 2] reads on a paired table of ``nrows`` rows (lo's block b
    picks the pair, clamped to the last), by ``pattern``:
    "mixed": each read at random one of hi in lo's block (delta 0), in the
    next (delta 1), 2-5 blocks on, in the block before lo's (hi < lo: delta
    wraps to 2^32 - 1), or lo in the last pair row (hi in its block or the
    next: its second half, zeros), lo's block random;
    "next distinct": every hi in the next block, the 32 reads of a warp in
    32 distinct pairs (more next halves than a warp's hi slots: batches);
    "next shared": every hi in the next block, every read of a warp in the
    warp's one pair; "far or wrapped": half 2-5 blocks on, half in the
    block before lo's; "last row": lo in the last pair row (half of them
    past it, clamped), hi in lo's block or the next."""
    off = lambda: rng.integers(0, d, size=n)  # noqa: E731
    b = rng.integers(1, nrows - 6, size=n)
    step = {"next distinct": np.ones(n, np.int64), "next shared": np.ones(n, np.int64)}.get(pattern)
    if pattern == "mixed":
        kind = rng.integers(0, 5, size=n)
        step = np.choose(kind, [0, 1, rng.integers(2, 6, size=n), -1, rng.integers(0, 2, size=n)])
        b = np.where(kind == 4, nrows - 1, b)
    elif pattern == "next distinct":
        P = (nrows - 2) // 32 * 32
        b = np.tile(rng.permutation(P), -(-n // P))[:n]
    elif pattern == "next shared":
        b = np.repeat(rng.integers(0, nrows - 2, size=-(-n // 32)), 32)[:n]
    elif pattern == "far or wrapped":
        step = np.where(np.arange(n) % 2 == 0, rng.integers(2, 6, size=n), -1)
    elif pattern == "last row":
        b = nrows - 1 + np.arange(n) % 2
        step = rng.integers(0, 2, size=n)
    return np.stack([b * d + off(), (b + step) * d + off()], axis=1)


@pytest.mark.parametrize("width", ["host", "device"])
@pytest.mark.parametrize("d", [192, 160])
@pytest.mark.parametrize("pattern", ["mixed", "next distinct", "next shared", "far or wrapped", "last row"])
def test_lf_round_paired_kernel_hi_slots(cuda, pattern, d, width):
    """K1's paired entry on 2^20 + 33 reads (k=3; full slots and a ragged
    last warp), one pattern of hi's block against lo's each
    (``_paired_reads``): the next halves in the hi slots, several batches of
    them, one shared by a warp, and every other hi counted on lo's row at
    its own offset, wrapped deltas and the last pair row included. At d=192
    the count reads 16-byte vectors, at d=160 words. "host": host-width
    rows at a base 4 B off a 16-byte boundary (copied by 4-byte units), iv
    8 B off (loaded and stored by words); "device": the engine's padded
    rows (16-byte units), iv aligned (16-byte pairs). out and ok
    bit-identical to the plain version; the ok reads whose hi lies in the
    table equal to K1's pair entry on the fused rows."""
    k, n = 3, (1 << 20) + 33
    _, index = _index(k, d, 20_000)
    fused_h = tables_from_index(index).entries
    table_h = build_paired_entries(fused_h if width == "host" else _rows(fused_h, torch.device("cpu")).numpy()
                                   .view(np.uint32))
    rng = np.random.default_rng(n + d + len(pattern) + len(width))
    iv_h = _paired_reads(rng, table_h.shape[0], d, pattern, n)
    skew = 1 if width == "host" else 0  # a word (4 B) into the table, an int64 (8 B) into iv
    buf = torch.zeros(table_h.size + skew, dtype=torch.int32, device=cuda)
    buf[skew:] = torch.from_numpy(np.ascontiguousarray(table_h).view(np.int32).reshape(-1)).to(cuda)
    paired = buf[skew:].view(table_h.shape)
    ivbuf = torch.zeros(2 * n + skew, dtype=torch.int64, device=cuda)
    ivbuf[skew:] = torch.from_numpy(iv_h.reshape(-1)).to(cuda)
    iv = ivbuf[skew:].view(n, 2)
    assert (paired.data_ptr() % 16 == 0) == (iv.data_ptr() % 16 == 0) == (width == "device")
    code = torch.from_numpy(rng.integers(0, 4**k, size=n)).to(cuda)
    dollar = torch.from_numpy(index_dollar(index)).to(cuda)
    delta = ((iv_h[:, 1] // d - iv_h[:, 0] // d) & 0xFFFFFFFF)
    assert {"next distinct": (delta == 1).all(), "next shared": (delta == 1).all(),
            "far or wrapped": (delta > 1).all() and (iv_h[:, 1] < iv_h[:, 0]).any(),
            "last row": (iv_h[:, 0] // d >= table_h.shape[0] - 1).all(),
            "mixed": all((delta == v).any() for v in (0, 1, 2, 0xFFFFFFFF))}[pattern]
    before = lf_mod.PAIRED_LAUNCHES
    got, ok = lf_mod.lf_round_paired(paired, iv, code, dollar, k, d)
    torch.cuda.synchronize()
    assert lf_mod.PAIRED_LAUNCHES == before + 1
    want, want_ok = lf_mod.lf_round_paired_reference(paired, iv, code, dollar, k, d)
    assert torch.equal(got, want) and torch.equal(ok, want_ok)
    assert torch.equal(ok.cpu(), torch.from_numpy(delta <= 1))
    # the fused rows are the pairs' first halves; past the last row the
    # paired layout reads its zero half where the fused round clamps
    fused = torch.from_numpy(np.ascontiguousarray(table_h[:, : table_h.shape[1] // 2]).view(np.int32)).to(cuda)
    inside = ok & (iv[:, 1] // d < table_h.shape[0])
    assert bool(inside.any()) == (pattern != "far or wrapped")
    assert torch.equal(got[inside], lf_mod.lf_round_pairs(fused, iv, code, dollar, k, d)[inside])


@pytest.mark.parametrize("layout", ["split", "alt_counters", "paired", "pad_words"])
@pytest.mark.parametrize("L,lut_m", [(24, 0), (24, 6), (31, 6)])
def test_layout_search_on_card_matches_plain_and_oracle(cuda, layout, L, lut_m):
    """The engine's layouts on the card: the intervals of the plain rounds
    and of the oracle, each layout's kernel launched every round (the
    paired layout also its repairs, on a text with long repeats)."""
    codes = _index(3, 192, 3000)[0].copy()
    codes[1000:2500] = np.tile(np.arange(4, dtype=np.uint8), 375)  # a repeat: intervals of 375+ rows
    index = build_index(codes, IndexConfig(k=3, d=192), sa_method="doubling")
    if layout == "alt_counters" and (lut_m or L % 3):
        pytest.skip("the alternate-counters search takes no LUT and no tail (XLAEngine refuses them)")
    if layout == "paired" and not lut_m:
        pytest.skip("the paired layout needs a LUT (XLAEngine refuses it without)")
    tail = derive_tail(index) if L % 3 else None
    rng = np.random.default_rng(L + lut_m)
    starts = rng.integers(0, len(codes) - L, size=100)
    starts[:30] = rng.integers(1000, 1500, size=30)
    queries = np.stack([codes[s : s + L] for s in starts])
    kw = {"split": {"layout": "split"}, "paired": {"layout": "paired"}, "pad_words": {"pad_words": 128},
          "alt_counters": {}}[layout]
    engine = SearchEngine(make_alt_counters(index) if layout == "alt_counters" else index, cuda,
                          lut_m=lut_m, tail_index=tail, **kw)
    name = {"split": "SPLIT_LAUNCHES", "alt_counters": "AC_LAUNCHES", "paired": "PAIRED_LAUNCHES",
            "pad_words": "PAIRS_LAUNCHES"}[layout]
    before = getattr(lf_mod, name)
    got = engine.search(queries, wave=32)
    assert getattr(lf_mod, name) - before >= 4 * ((L - lut_m) // 3)  # four waves
    np.testing.assert_array_equal(got, engine.search(queries, step=lf_mod.lf_round_reference))
    np.testing.assert_array_equal(got, search_oracle(index, queries, tail_index=tail))
    if layout == "paired":
        assert 0 < engine.last_repair_fraction < 1


@pytest.mark.parametrize("gather", ["fused", "dma"])
@pytest.mark.parametrize("L,lut_m", [(24, 0), (24, 6), (31, 6)])
def test_search_on_card_matches_plain_and_oracle(cuda, L, lut_m, gather):
    codes, index = _index(3, 192, 3000)
    tail = derive_tail(index) if L % 3 else None
    rng = np.random.default_rng(L + lut_m)
    starts = rng.integers(0, len(codes) - L, size=100)
    queries = np.stack([codes[s : s + L] for s in starts])
    engine = SearchEngine(index, cuda, lut_m=lut_m, tail_index=tail, gather=gather)
    before = rg_mod.LAUNCHES, lf_mod.ROWS_LAUNCHES
    got = engine.search(queries, wave=32)
    rounds = 4 * ((L - lut_m) // 3)  # four waves
    want = (rounds, rounds) if gather == "dma" else (0, 0)
    assert (rg_mod.LAUNCHES - before[0], lf_mod.ROWS_LAUNCHES - before[1]) == want
    np.testing.assert_array_equal(got, engine.search(queries, step=lf_mod.lf_round_reference))
    np.testing.assert_array_equal(got, search_oracle(index, queries, tail_index=tail))


@pytest.mark.parametrize("gather", ["fused", "dma"])
@pytest.mark.parametrize("lut_m", [0, 6])
def test_search_varlen_on_card_matches_plain_and_oracle(cuda, lut_m, gather):
    codes, index = _index(3, 192, 3000)
    tail = derive_tail(index)
    rng = np.random.default_rng(lut_m)
    lengths = rng.integers(6, 41, size=100)
    batch = np.full((100, 40), 0xFF, dtype=np.uint8)
    reads = []
    for i, L in enumerate(lengths):
        s = int(rng.integers(0, len(codes) - L))
        reads.append(codes[s : s + L])
        batch[i, 40 - L :] = reads[-1]
    engine = SearchEngine(index, cuda, lut_m=lut_m, tail_index=tail, gather=gather)
    got = engine.search_varlen(batch, wave=32)
    np.testing.assert_array_equal(got, engine.search_varlen(batch, step=lf_mod.lf_round_reference))
    want = np.stack([search_oracle(index, r[None], tail_index=tail)[0] for r in reads])
    np.testing.assert_array_equal(got, want)
    assert (got[:, 1] > got[:, 0]).all()


@functools.lru_cache(maxsize=None)
def _walk_tables(d, s, n_bases):
    codes = np.random.default_rng(n_bases + s).integers(0, 4, size=n_bases, dtype=np.uint8)
    sa = suffix_array(codes, "doubling")
    return sa, loc_mod.locate_tables_from_index(build_locate(codes, sample_rate=s, d=d, sa=sa))


@pytest.mark.parametrize("n", [1, 31, 4099, 1 << 20])
@pytest.mark.parametrize("width", ["host", "device"])
@pytest.mark.parametrize("s", [1, 4, 32])
@pytest.mark.parametrize("d", [32, 128, 192, 448, 960])  # d=960: over 48 KB of staged rows a block
def test_locate_walk_kernel_matches_plain(cuda, d, s, width, n):
    # a text of c*d - 1 bases: bwtsize % d == 0, so bwtsize reads the sentinel row
    sa, t = _walk_tables(d, s, 7 * d - 1)
    bwtsize = sa.shape[0]
    rng = np.random.default_rng(n * s)
    p = rng.integers(0, bwtsize, size=n)
    # every warp of the first lanes holds walks of 0 and of s - 1 hops side
    # by side (the row of SA value v walks v % s hops)
    short, long_ = np.flatnonzero(sa % s == 0), np.flatnonzero(sa % s == s - 1)
    head = min(n, 4096) // 2
    p[0:2 * head:2] = rng.choice(short, size=head)
    p[1:2 * head:2] = rng.choice(long_, size=head)
    # bwtsize itself, rows past it in its block and past the table (clamped)
    tail = [bwtsize, bwtsize + 3, bwtsize + 5 * d][: max(0, min(n, 4) - 1)]
    p[n - len(tail):] = tail
    rows = t.rows if width == "host" else _rows(t.rows, torch.device("cpu")).numpy().view(np.uint32)
    args = [torch.from_numpy(a).to(cuda) for a in (np.ascontiguousarray(rows).view(np.int32),
                                                  t.samples.view(np.int32), t.dollar.astype(np.int64), p)]
    before = loc_mod.LAUNCHES
    got = loc_mod.locate_walk(*args, d, s)
    torch.cuda.synchronize()
    assert loc_mod.LAUNCHES == before + 1
    assert torch.equal(got, loc_mod.locate_walk_reference(*args, d, s))
    inside = p < bwtsize
    np.testing.assert_array_equal(got.cpu().numpy()[inside], sa[p[inside]])
    # a lane never marked within the trip count stays 0xFFFFFFFF
    short_trip = loc_mod.locate_walk(*args, d, max(1, s // 2)).cpu().numpy()[inside]
    want = np.where(sa[p[inside]] % s < max(1, s // 2), sa[p[inside]], 0xFFFFFFFF)
    np.testing.assert_array_equal(short_trip, want)


@pytest.mark.parametrize("L,lut_m", [(24, 0), (25, 6)])
def test_search_locate_on_card_matches_plain_and_oracle(cuda, L, lut_m):
    codes = np.random.default_rng(L).integers(0, 4, size=3000, dtype=np.uint8)
    sa = suffix_array(codes, "doubling")
    index = build_index(codes, IndexConfig(k=3, d=192), sa=sa)
    loc = build_locate(codes, sample_rate=8, d=192, sa=sa)
    rng = np.random.default_rng(lut_m)
    queries = np.stack([codes[s : s + L] for s in rng.integers(0, len(codes) - L, size=100)])
    queries[:10, :8] = queries[:10, 8:16]  # some reads with no hit
    engine = SearchLocateEngine(index, loc, cuda, max_hits=6, lut_m=lut_m)
    before = loc_mod.LAUNCHES
    iv, pos = engine.search_locate(queries, wave=32)
    assert loc_mod.LAUNCHES - before == 4  # four waves
    plain = engine.search_locate(queries, step=lf_mod.lf_round_reference,
                                 walk=loc_mod.locate_walk_reference)
    np.testing.assert_array_equal(iv, plain[0])
    np.testing.assert_array_equal(pos, plain[1])
    tail = derive_tail(index) if L % 3 else None
    np.testing.assert_array_equal(iv, search_oracle(index, queries, tail_index=tail))
    np.testing.assert_array_equal(pos, locate_hits(loc, iv, 6))


def test_locate_mismatch_on_card_matches_plain(cuda):
    codes = np.random.default_rng(3).integers(0, 4, size=3000, dtype=np.uint8)
    sa = suffix_array(codes, "doubling")
    index = build_index(codes, IndexConfig(k=3, d=192), sa=sa)
    loc = build_locate(codes, sample_rate=8, d=192, sa=sa)
    rng = np.random.default_rng(4)
    queries = np.stack([codes[s : s + 9] for s in rng.integers(0, len(codes) - 9, size=40)])
    queries[::2, 4] = (queries[::2, 4] + 1) % 4  # one substitution in half the reads
    engine = SearchLocateEngine(index, loc, cuda, max_hits=8)
    got = engine.locate_mismatch(queries, wave=16)
    plain = engine.locate_mismatch(queries, step=lf_mod.lf_round_reference,
                                   walk=loc_mod.locate_walk_reference)
    np.testing.assert_array_equal(got, plain)
    wins = np.lib.stride_tricks.sliding_window_view(codes, 9)
    for q, row in zip(queries, got):
        hits = row[row != 0xFFFFFFFF].astype(np.int64)
        assert len(hits) == min(8, int(((wins != q).sum(1) <= 1).sum()))
        assert ((wins[hits] != q).sum(1) <= 1).all()
    counts = SearchEngine(index, cuda).count(queries, mismatches=1, wave=16)
    np.testing.assert_array_equal(counts, ((wins[None] != queries[:, None]).sum(2) <= 1).sum(1))


def test_bench_records_on_card(cuda):
    """``run_bench`` (both engines) and ``run_bench_search_locate`` at 1 Mbase
    on the card: every bit-exactness field true, the card named, and each
    record's kernel launched (K1's pair entry, its rows entry, K4)."""
    from tpufm_torch import bench

    name = torch.cuda.get_device_name(cuda)
    for engine, counter in (("xla", "PAIRS_LAUNCHES"), ("pallas", "ROWS_LAUNCHES")):
        before = getattr(lf_mod, counter)
        r = bench.run_bench(refsize=1_000_000, k=3, d=192, num_queries=1 << 16, query_len=120,
                            iterations=2, engine=engine, lut_m=12, device=cuda)
        assert getattr(lf_mod, counter) > before
        d = r["detail"]
        assert d["bit_exact_vs_oracle"] and d["bit_exact_vs_oracle_sample"] and d["bit_exact_vs_plain_full"]
        assert d["device"] == name and d["verified_reads"] == 1 << 16 and len(d["pass_seconds"]) == 2
    before = loc_mod.LAUNCHES
    r = bench.run_bench_search_locate(refsize=1_000_000, k=3, d=192, num_queries=1 << 16, iterations=2,
                                      lut_m=12, max_hits=16, device=cuda)
    assert loc_mod.LAUNCHES > before
    assert r["detail"]["bit_exact_vs_oracle"] and r["detail"]["device"] == name


def _verify_text(n, seed):
    codes = np.random.default_rng(seed).integers(0, 4, size=n, dtype=np.uint8)
    return codes, torch.from_numpy(seed_mod.pack_text_words(codes).view(np.int32))


@pytest.mark.parametrize("B,C", [(37, 13), (2048, 96)])
@pytest.mark.parametrize("L", [1, 15, 16, 17, 30, 61, 120, 151, 300])
def test_hamming_verify_kernel_matches_plain(cuda, L, B, C):
    """K5 on a grid of B reads x C lanes: starts at every 16-base offset, the
    last valid start n - L, starts past it (the word index clamps, as the
    JAX gather clamps) and invalid lanes (L + 1)."""
    n = 1999
    codes, text = _verify_text(n, L)
    rng = np.random.default_rng(B + L)
    pos = rng.integers(0, n - L + 1, size=(B, C))
    pos.flat[: min(pos.size, 32)] = np.arange(16 * 2, 16 * 2 + 32)[: min(pos.size, 32)]  # offsets 0-15
    pos[0, 0], pos[-1, -1] = n - L, n + 40
    reads = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    reads[::2] = codes[pos[::2, 0, None] % (n - L + 1) + np.arange(L)]  # some near matches
    valid = rng.random((B, C)) < 0.7
    t, p, v = text.to(cuda), torch.from_numpy(pos).to(cuda), torch.from_numpy(valid).to(cuda)
    q = seed_mod.pack_query_words(torch.from_numpy(reads).to(cuda))
    before = seed_mod.LAUNCHES
    got = seed_mod.hamming_to_text(t, p, q, v, L)
    torch.cuda.synchronize()
    assert seed_mod.LAUNCHES == before + 1
    want = seed_mod.hamming_to_text_reference(t, p, q, v, L)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    inside = valid & (pos <= n - L)
    windows = codes[pos[inside][:, None] + np.arange(L)]
    np.testing.assert_array_equal(got.cpu().numpy()[inside], (windows != np.repeat(reads, C, 0)[inside.reshape(-1)]).sum(1))
    assert (got.cpu().numpy()[~valid] == L + 1).all()


@pytest.mark.parametrize("L,E", [(17, 1), (32, 1), (33, 2), (64, 3), (120, 1), (120, 2), (120, 3), (151, 1),
                                 (151, 2), (151, 3), (256, 2), (257, 1), (300, 2)])
def test_myers_verify_kernel_matches_plain(cuda, L, E):
    """K6 against its plain version on B reads x C lanes: anchors across the
    text, windows past its end, invalid lanes; reads of 257 and 300 bp take
    the scratch-buffer path (W > 8)."""
    n = 1500
    codes, text = _verify_text(n, L + E)
    rng = np.random.default_rng(L * 7 + E)
    B, C = 23, 9
    a = rng.integers(-E, n - 1 + E + 1, size=(B, C))
    a[0, :3] = [n - 1 + E, n - 1, n - L // 2]  # windows past the text end
    reads = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    for b in range(0, B, 2):  # mutated text windows: small distances occur
        s0 = int(rng.integers(0, n - L - E))
        a[b, 1:] = s0
        w = list(codes[s0 : s0 + L + E])
        for _ in range(E):
            p = int(rng.integers(0, len(w) - 1))
            w.insert(p, int(rng.integers(0, 4))) if rng.random() < 0.5 else w.__delitem__(p)
        reads[b] = (w + [0] * L)[:L]
    lo, hi = np.maximum(a - E, 0), np.minimum(a + E, n - 1)
    valid = rng.random((B, C)) < 0.8
    W = -(-L // 32)
    args = [torch.from_numpy(x).to(cuda) for x in (lo, hi, valid)]
    peq = edit_mod.build_peq(torch.from_numpy(reads[:, ::-1].copy()).to(cuda), W)
    t = text.to(cuda)
    before = edit_mod.LAUNCHES
    dist, start = edit_mod.myers_verify(t, n, peq, *args, L, E)
    torch.cuda.synchronize()
    assert edit_mod.LAUNCHES == before + 1
    want_d, want_s = edit_mod.myers_verify_reference(t, n, peq, *args, L, E)
    assert torch.equal(dist, want_d) and torch.equal(start, want_s)
    assert (dist.cpu().numpy()[~valid] == L + 1).all() and (start.cpu().numpy()[~valid] == 0xFFFFFFFF).all()
    assert (dist.cpu().numpy()[::2][valid[::2]] <= E).any()  # the mutated windows are found


#: lanes a block of K5 and K6 packs (csrc/valid_tiles.cuh kTile)
TILE = 2048
#: valid masks of the tiling cases: (B, C, share valid, or "last" for one
#: valid lane at the last slot of each tile); "unaligned" puts the mask off
#: its 16-byte boundary (the kernels then read it a byte a lane)
TILE_CASES = {
    "all_valid": (40, 96, 1.0),
    "none_valid": (40, 96, 0.0),
    "last_of_each_tile": (64, 96, "last"),
    "ragged_end": (37, 61, 0.7),
    "under_one_tile": (5, 7, 0.7),
    "read_wider_than_tile": (2, 2500, 0.5),
    "unaligned_mask": (37, 61, 0.7),
}


def _tile_mask(case, rng, cuda):
    """(valid bool [B, C] on the host, the same on the card) of a tiling case."""
    B, C, share = TILE_CASES[case]
    if share == "last":
        valid = np.zeros(B * C, bool)
        valid[TILE - 1 :: TILE] = True
        valid = valid.reshape(B, C)
    else:
        valid = rng.random((B, C)) < share
    v = torch.from_numpy(valid)
    if case == "unaligned_mask":
        v = torch.zeros(B * C + 1, dtype=torch.bool).to(cuda)[1:].copy_(v.reshape(-1)).reshape(B, C)
        assert v.is_contiguous() and v.data_ptr() % 16
        return valid, v
    return valid, v.to(cuda)


@pytest.mark.parametrize("case", list(TILE_CASES))
@pytest.mark.parametrize("L", [1, 16, 17, 47, 64, 100, 120, 151, 160, 161, 300])
def test_hamming_verify_tiles_match_plain(cuda, case, L):
    """K5's tile compaction on the tiling cases, at every W it has a kernel
    for (L <= 160: W = 1-10) and past them (its loop): bit-identical to the
    plain version, L + 1 on every invalid lane."""
    n = 1999
    codes, text = _verify_text(n, L)
    rng = np.random.default_rng(L)
    valid, v = _tile_mask(case, rng, cuda)
    B, C = valid.shape
    pos = rng.integers(0, n - L + 1, size=(B, C))
    pos.flat[:3] = [n - L, n - L + 5, n + 40]  # the last valid start and starts past it (clamped)
    reads = codes[pos[:, -1, None] + np.arange(L)]
    reads[:, ::11] ^= 1
    t, p = text.to(cuda), torch.from_numpy(pos).to(cuda)
    q = seed_mod.pack_query_words(torch.from_numpy(reads).to(cuda))
    before = seed_mod.LAUNCHES
    got = seed_mod.hamming_to_text(t, p, q, v, L)
    torch.cuda.synchronize()
    assert seed_mod.LAUNCHES == before + 1
    assert torch.equal(got, seed_mod.hamming_to_text_reference(t, p, q, v, L))
    assert (got.cpu().numpy()[~valid] == L + 1).all()


@pytest.mark.parametrize("case", list(TILE_CASES))
@pytest.mark.parametrize("L,E", [(17, 1), (40, 2), (90, 3), (120, 1), (120, 2), (151, 3), (180, 1), (220, 2),
                                 (256, 3), (257, 1), (300, 2), (300, 3)])
def test_myers_verify_tiles_match_plain(cuda, case, L, E):
    """K6's tile compaction on the tiling cases at W = 1-10 (W > 8 keeps its
    bit vectors in the scratch buffer, a slot a thread), E = 1-3:
    bit-identical to the plain version, (L + 1, 0xFFFFFFFF) on every
    invalid lane."""
    n = 1500
    codes, text = _verify_text(n, L + E)
    rng = np.random.default_rng(L * 7 + E)
    valid, v = _tile_mask(case, rng, cuda)
    B, C = valid.shape
    a = rng.integers(-E, n + E, size=(B, C))
    a.flat[:3] = [n - 1 + E, n - 1, -E]  # windows past the text end, an anchor left of it
    origin = rng.integers(0, n - L - E, size=B)
    a[:, 1] = origin
    reads = codes[origin[:, None] + np.arange(L)]
    reads[:, ::37] ^= 1
    lo, hi = np.maximum(a - E, 0), np.minimum(a + E, n - 1)
    args = [torch.from_numpy(x).to(cuda) for x in (lo, hi)] + [v]
    peq = edit_mod.build_peq(torch.from_numpy(reads[:, ::-1].copy()).to(cuda), -(-L // 32))
    t = text.to(cuda)
    before = edit_mod.LAUNCHES
    dist, start = edit_mod.myers_verify(t, n, peq, *args, L, E)
    torch.cuda.synchronize()
    assert edit_mod.LAUNCHES == before + 1
    want_d, want_s = edit_mod.myers_verify_reference(t, n, peq, *args, L, E)
    assert torch.equal(dist, want_d) and torch.equal(start, want_s)
    assert (dist.cpu().numpy()[~valid] == L + 1).all() and (start.cpu().numpy()[~valid] == 0xFFFFFFFF).all()


def _approx_setup(k=3, d=64, n=3000, seed=5):
    codes = np.random.default_rng(seed).integers(0, 4, size=n, dtype=np.uint8)
    sa = suffix_array(codes, "doubling")
    return (codes, build_index(codes, IndexConfig(k=k, d=d), sa=sa),
            build_locate(codes, sample_rate=8, d=d, sa=sa))


def _planted(codes, L, m, n_reads, seed):
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(codes) - L + 1, size=n_reads)
    qs = np.stack([codes[s : s + L].copy() for s in starts])
    for i in range(n_reads):
        for p in rng.choice(L, size=m, replace=False):
            qs[i, p] = (qs[i, p] + rng.integers(1, 4)) & 3
    return qs, starts


_PLAIN = dict(step=lf_mod.lf_round_reference, walk=loc_mod.locate_walk_reference)


@pytest.mark.parametrize("m,L,lut_m", [(2, 30, 0), (2, 120, 12), (3, 151, 6), (3, 30, 12)])  # 6-base seeds: no LUT
def test_seed_extend_on_card_matches_plain_and_oracle(cuda, m, L, lut_m):
    codes, index, loc = _approx_setup()
    qs, starts = _planted(codes, L, m, 200, seed=L)
    eng = seed_mod.SeedExtendEngine(index, loc, codes, mismatches=m, seed_hits=64, max_hits=8,
                                    lut_m=lut_m, device=cuda)
    before = (seed_mod.LAUNCHES, loc_mod.LAUNCHES)
    got = eng.locate_approx(qs, wave=64)
    assert seed_mod.LAUNCHES - before[0] == 4 and loc_mod.LAUNCHES - before[1] == 4
    plain = eng.locate_approx(qs, verify=seed_mod.hamming_to_text_reference, **_PLAIN)
    for a, b in zip(got, plain):
        np.testing.assert_array_equal(a, b)
    counts, want = seed_mod.seed_extend_oracle(codes, qs, m)
    assert not got[2].any()
    np.testing.assert_array_equal(got[1], counts)
    for row, w, s in zip(got[0], want, starts):
        np.testing.assert_array_equal(row[row != 0xFFFFFFFF], w[:8])
        assert s in row


@pytest.mark.parametrize("E,L,lut_m", [(1, 30, 0), (2, 120, 12), (3, 151, 6), (2, 300, 6)])
def test_edit_extend_on_card_matches_plain_and_oracle(cuda, E, L, lut_m):
    codes, index, loc = _approx_setup()
    rng = np.random.default_rng(E + L)
    qs, origins = [], rng.integers(0, len(codes) - L - E, size=120)
    for s0 in origins:
        w = list(codes[s0 : s0 + L + E])
        for _ in range(E):
            p = int(rng.integers(0, len(w) - 1))
            w.insert(p, int(rng.integers(0, 4))) if rng.random() < 0.5 else w.__delitem__(p)
        qs.append(np.array(w[:L], np.uint8))
    qs = np.stack(qs)
    eng = edit_mod.EditExtendEngine(index, loc, codes, edits=E, seed_hits=64, max_hits=8, lut_m=lut_m,
                                    device=cuda)
    before = edit_mod.LAUNCHES
    got = eng.locate_edits(qs, wave=50)
    assert edit_mod.LAUNCHES - before == 3
    plain = eng.locate_edits(qs, verify=edit_mod.myers_verify_reference, **_PLAIN)
    for a, b in zip(got, plain):
        np.testing.assert_array_equal(a, b)
    want = edit_mod.edit_extend_oracle(codes, qs, E)
    for i, row in enumerate(got[0]):
        sites = row[row != 0xFFFFFFFF].astype(np.int64)
        assert (want[i, sites] <= E).all()
        assert sites.size and np.abs(sites - origins[i]).min() <= 2 * E


@pytest.mark.parametrize("B", [201, 1])
@pytest.mark.parametrize("source", ["exact", "m2", "e1"])
def test_data_parallel_search_locate_on_card_matches_one_device(cuda, source, B):
    """``DataParallelSearchLocate`` over two shards of one card (the batch
    padded by cycling to an even count) against the one-device engine and
    the plain path on the same reads; one walk (K4) and one verify (K5,
    K6) a shard, every shard having lanes to walk."""
    from tpufm_torch.parallel import DataParallelSearchLocate, Mesh

    codes, index, loc = _approx_setup()
    qs, _ = _planted(codes, 30, {"exact": 0, "m2": 2, "e1": 1}[source], B, seed=B)
    dp = DataParallelSearchLocate(index, loc, Mesh([cuda] * 2), max_hits=8, lut_m=6)
    if source == "exact":
        run = dp.search_locate
        one = SearchLocateEngine(index, loc, cuda, max_hits=8, lut_m=6).search_locate
        counter, verify = loc_mod, {}
    elif source == "m2":
        run = functools.partial(dp.locate_approx, text=codes, mismatches=2)
        one = seed_mod.SeedExtendEngine(index, loc, codes, mismatches=2, max_hits=8, lut_m=6,
                                        device=cuda).locate_approx
        counter, verify = seed_mod, {"verify": seed_mod.hamming_to_text_reference}
    else:
        run = functools.partial(dp.locate_edits, text=codes, edits=1)
        one = edit_mod.EditExtendEngine(index, loc, codes, edits=1, max_hits=8, lut_m=6, device=cuda).locate_edits
        counter, verify = edit_mod, {"verify": edit_mod.myers_verify_reference}
    run(qs)  # builds the approximate engines and their text
    before = (counter.LAUNCHES, loc_mod.LAUNCHES)
    got = run(qs)
    torch.cuda.synchronize()
    assert (counter.LAUNCHES - before[0], loc_mod.LAUNCHES - before[1]) == (2, 2)
    for a, b, c in zip(got, one(qs), run(qs, **verify, **_PLAIN)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
        assert a.shape[0] == B


@pytest.mark.parametrize("source", [{}, {"mismatches": 1}, {"mismatches": 2}, {"edits": 1}],
                         ids=["exact", "m1", "m2", "e1"])
@pytest.mark.parametrize("L1,L2", [(30, 30), (30, 24)])
def test_paired_on_card_matches_plain_and_oracle(cuda, source, L1, L2):
    from tpufm_torch.host.seqio import generate_read_pairs

    codes, index, loc = _approx_setup(k=2)
    r1, r2, (ls, rs, minus) = generate_read_pairs(codes, max(L1, L2), 96, 100, 300, seed=L2,
                                                   return_truth=True)
    r1, r2 = r1[:, :L1], r2[:, :L2]
    text = codes if source.get("mismatches", 0) >= 2 or source.get("edits") else None
    eng = PairedEndEngine(index, loc, 100, 300, max_hits=8, max_pairs=4, text=text, device=cuda, **source)
    got = eng.pair(r1, r2, wave=40)
    verify = {"mismatches": {2: seed_mod.hamming_to_text_reference}, "edits": {1: edit_mod.myers_verify_reference}}
    extra = {"verify": verify[key][val] for key, val in source.items() if val in verify.get(key, {})}
    plain = eng.pair(r1, r2, wave=40, **_PLAIN, **extra)
    for a, b in zip(got, plain):
        np.testing.assert_array_equal(a, b)
    if not source:
        want = pair_oracle(codes, r1, r2, 100, 300, device=cuda)
        for i, triples in enumerate(want):
            found = {(int(l), int(r), int(s)) for (l, r), s in zip(got[0][i], got[1][i]) if l != 0xFFFFFFFF}
            assert got[2][i] == len(triples) and found <= set(triples)
    if L1 == L2:  # the truth pairs are whole reads only then
        hit = (got[0][..., 0] == ls[:, None]) & (got[0][..., 1] == rs[:, None]) & (got[1] == minus[:, None])
        assert hit.any(axis=1).all()


def _fastq(path, reads, rng):
    with open(path, "w") as fp:
        fp.write("".join(f"@a{i}\n{''.join('ACGT'[c] for c in r)}\n+\n"
                         f"{''.join(chr(33 + int(x)) for x in rng.integers(0, 41, size=len(r)))}\n"
                         for i, r in enumerate(reads)))
    return str(path)


@functools.lru_cache(maxsize=None)
def _align_inputs(root: str):
    """A 3-record reference and read files: 120 bp reads (a third with a
    substitution, a third with a deletion), FR pairs, reads of 60-120 bp."""
    import os

    from tpufm_torch.host.seqio import generate_read_pairs

    rng = np.random.default_rng(77)
    recs = [rng.integers(0, 4, size=n, dtype=np.uint8) for n in (30_000, 12_000, 20_000)]
    codes = np.concatenate(recs)
    ref = os.path.join(root, "g.fa")
    with open(ref, "w") as fp:
        fp.write("".join(f">chr{i + 1}\n{''.join('ACGT'[c] for c in r)}\n" for i, r in enumerate(recs)))
    starts = rng.integers(0, codes.shape[0] - 130, size=512)
    fixed = [codes[s:s + 121].copy() for s in starts]
    fixed = [np.delete(r, 40) if i % 3 == 2 else r[:120] for i, r in enumerate(fixed)]
    for r in fixed[1::3]:
        r[60] = (r[60] + 1) % 4
    fixed = [(3 - r[::-1]) if i % 2 else r for i, r in enumerate(fixed)]
    r1, r2 = generate_read_pairs(codes, 100, 256, 250, 450, seed=5)
    mixed = [codes[s:s + n] for s, n in zip(starts, rng.integers(60, 121, size=512))]
    return ref, {"fixed": _fastq(os.path.join(root, "f.fq"), fixed, rng),
                 "r1": _fastq(os.path.join(root, "r1.fq"), r1, rng), "r2": _fastq(os.path.join(root, "r2.fq"), r2, rng),
                 "mixed": _fastq(os.path.join(root, "m.fq"), mixed, rng)}


@pytest.mark.parametrize("reads,extra", [
    ("fixed", []), ("fixed", ["--mismatches", "1"]), ("fixed", ["--mismatches", "2"]), ("fixed", ["--edits", "2"]),
    ("r1", ["-2", "R2", "--insert-min", "250", "--insert-max", "450"]),
    ("r1", ["-2", "R2", "--edits", "1", "--bam"]), ("mixed", []), ("mixed", ["--mismatches", "2", "--bam"])],
    ids=["exact", "m1", "m2", "e2", "paired", "paired-e1-bam", "mixed", "mixed-m2-bam"])
def test_align_on_card_matches_cpu(cuda, tmp_path_factory, reads, extra):
    """``align --device cuda`` writes the bytes that ``--device cpu`` writes,
    and launches the kernels of its path."""
    from tpufm_torch import cli

    ref, files = _align_inputs(str(tmp_path_factory.getbasetemp()))
    extra = [files["r2"] if x == "R2" else x for x in extra]
    out = tmp_path_factory.mktemp("align")
    argv = ["align", ref, files[reads], "--sample-rate", "8", *extra]
    cli.main([*argv, "-o", str(out / "cpu.out"), "--device", "cpu"])
    for mod, attr in ((lf_mod, "PAIRS_LAUNCHES"), (loc_mod, "LAUNCHES"), (seed_mod, "LAUNCHES"),
                      (edit_mod, "LAUNCHES")):
        setattr(mod, attr, 0)
    cli.main([*argv, "-o", str(out / "cuda.out"), "--device", "cuda"])
    assert (out / "cuda.out").read_bytes() == (out / "cpu.out").read_bytes()
    assert lf_mod.PAIRS_LAUNCHES > 0 and loc_mod.LAUNCHES > 0
    assert (seed_mod.LAUNCHES > 0) == ("--mismatches" in extra and extra[extra.index("--mismatches") + 1] == "2")
    assert (edit_mod.LAUNCHES > 0) == ("--edits" in extra)


#: K7's cases as (d, n, k, text): k 1-4 on edge sizes, then k 5-8 (small
#: texts: the plain version loops over the 4^k codes), texts shorter than k
#: (the '$' rows wrap several times), lengths off the 16-base pack, n + 1 a
#: multiple of 32 but not of d, one-base and two-base texts (every lane of a
#: word holds one code) and FM blocks of more words than a warp loads at once
K7_CASES = [
    *(pytest.param(d, n, k, "random", id=f"{d}-{n}-{k}") for k in (1, 2, 3, 4)
      for d, n in ((32, 0), (32, 5), (32, 31), (32, 1000), (64, 127), (192, 20000), (192, 191), (960, 5000),
                   (128, 65535))),
    *(pytest.param(d, n, k, "random", id=f"{d}-{n}-{k}") for d, n, k in (
        (32, 100, 5), (64, 300, 5), (1024, 3000, 5), (4096, 9000, 5), (32, 40, 6), (96, 500, 6), (32, 50, 7),
        (960, 2000, 8),
        (32, 1, 2), (32, 1, 4), (32, 2, 3), (32, 2, 4), (32, 3, 4), (32, 0, 6), (32, 3, 7), (32, 5, 8),
        (32, 17, 3), (32, 47, 4), (64, 1009, 2), (192, 4097, 1),
        (96, 319, 3), (192, 223, 4), (960, 4095, 2),
        (4096, 20000, 3), (1024, 70000, 4))),
    *(pytest.param(d, n, k, text, id=f"{d}-{n}-{k}-{text}") for d, n, k, text in (
        (192, 5000, 3, "A"), (32, 1000, 1, "A"), (64, 200, 8, "A"), (192, 5001, 4, "AC"), (32, 300, 6, "AC"),
        (4096, 10000, 2, "AC"))),
]


@pytest.mark.parametrize("d,n,k,text", K7_CASES)
def test_build_tables_kernel_matches_plain(cuda, d, n, k, text):
    """K7 against ``build_tables_reference`` on the same values: the
    counts, bit-planes (row E zero) and '$' positions, at k 1-8; n + 1 a
    multiple of d (31, 127, 191, 65535: no padding), one block (5), the
    empty text and texts shorter than k, lengths off the 16-base pack, FM
    blocks of more words than a warp loads at once (d 960-4096), and texts
    of one base ("A") or a two-base period ("AC"), where every lane of a
    word holds the same code. The plain version runs on the CUDA tensors at
    k <= 4 and on their CPU copies past that (4^k codes of small launches
    each)."""
    from tpufm_torch.index import builder_device as bd

    rng = np.random.default_rng(n + k)
    if text == "random":
        codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    else:
        codes = np.resize(np.array(["ACGT".index(b) for b in text], dtype=np.uint8), n)
    cd = torch.from_numpy(codes).to(cuda)
    sa = torch.from_numpy(suffix_array(codes).astype(np.int32)).to(cuda)
    before, packs = bd.LAUNCHES, bd.PACK_LAUNCHES
    got = bd.build_tables(cd, sa, k, d)
    assert bd.LAUNCHES == before + 1 and bd.PACK_LAUNCHES == packs + 1
    plain_on = cuda if k <= 4 else torch.device("cpu")
    want = bd.build_tables_reference(cd.to(plain_on), sa.to(plain_on), k, d)
    torch.cuda.synchronize()
    for g, w, name in zip(got, want, ("counts", "bitmaps", "dollar_pos")):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g.to(plain_on), w), name


@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 33, 4099, 1 << 20])
@pytest.mark.parametrize("offset", [0, 3])
def test_pack_text_kernel_matches_plain(cuda, n, offset):
    """K7's text pack on the card against ``pack_text_2bit_reference`` on the
    same CUDA text (codes 0-6: bits past the two low ones dropped), on a
    text at a 16-byte boundary (16-byte loads) and one 3 bytes off it (byte
    loads), with lengths off the 16-base word."""
    from tpufm_torch.index import builder_device as bd

    codes = np.random.default_rng(n).integers(0, 7, size=n + offset, dtype=np.uint8)
    cd = torch.from_numpy(codes).to(cuda)[offset:]
    before = bd.PACK_LAUNCHES
    got = bd.pack_text_2bit(cd)
    assert bd.PACK_LAUNCHES == before + 1
    want = bd.pack_text_2bit_reference(cd)
    assert got.dtype == want.dtype and got.shape == want.shape and torch.equal(got, want)


@pytest.mark.parametrize("n,k,d", [(0, 1, 32), (1, 2, 32), (3001, 3, 192), (200_000, 3, 192), (50_000, 4, 64)])
def test_device_build_on_card_matches_host(cuda, n, k, d):
    """The whole device build on the card (the sort, K7, the corrections,
    the locate tables) equal to the host builders, and the device-resident
    index searching to the oracle's intervals. The texts have at least k - 1
    bases, as the host builder needs (a shorter one leaves it some '$'
    positions unset)."""
    from tpufm_torch.index import builder_device as bd
    from tpufm_torch.index.sa_device import suffix_array_device

    codes = np.random.default_rng(n).integers(0, 4, size=n, dtype=np.uint8)
    sa = suffix_array(codes)
    np.testing.assert_array_equal(suffix_array_device(codes, cuda), sa)
    host = build_index(codes, IndexConfig(k=k, d=d), sa=sa)
    got = bd.build_index_device(codes, IndexConfig(k=k, d=d), device=cuda)
    for f in ("occ", "bitmaps", "dollar_pos", "dollar_base"):
        a, b = getattr(got, f), getattr(host, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    loc = bd.build_locate_device(codes, sample_rate=8, d=d, device=cuda)
    want = build_locate(codes, sample_rate=8, d=d, sa=sa)
    for f in ("samples", "mark_words", "mark_rank"):
        a, b = getattr(loc, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    if n > 1000:
        dev = bd.build_index_device(codes, IndexConfig(k=k, d=d), return_host=False, device=cuda)
        reads = np.stack([codes[s:s + 24] for s in np.random.default_rng(1).integers(0, n - 24, 256)])
        np.testing.assert_array_equal(SearchEngine(dev, cuda, lut_m=12 - 12 % k).search(reads),
                                      search_oracle(host, reads))


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("n,d", [(10_000, 192), (4095, 64), (70_001, 32)])
def test_build_tables_slice_kernel_matches_plain(cuda, n, d, k):
    """K7 on each shard's rows of a four-shard split, as the sharded build
    launches it (``build_tables(..., p0=s*m)``, m the d-aligned rows a
    shard): every shard's counts, planes and global '$' rows equal to the
    plain version's on the same CUDA tensors: the last shard's rows past n +
    1 are pads (three whole pad blocks at n = 10,000, d = 192; a part of
    the last block at n = 70,001, d = 32; none at n = 4095, d = 64, where
    the four shards hold the n + 1 rows exactly). One launch a shard."""
    from tpufm_torch.index import builder_device as bd
    from tpufm_torch.index.builder_sharded import table_rows

    codes = np.random.default_rng(n + k).integers(0, 4, size=n, dtype=np.uint8)
    cd = torch.from_numpy(codes).to(cuda)
    m = table_rows(n + 1, d, 4)
    sa = np.zeros(4 * m, np.int32)
    sa[:n + 1] = suffix_array(codes)
    sa[n + 1:] = 7  # a pad's value is never read
    sa = torch.from_numpy(sa).to(cuda)
    for s in range(4):
        rows = sa[s * m:(s + 1) * m]
        before = bd.LAUNCHES
        got = bd.build_tables(cd, rows, k, d, p0=s * m, big=n + 1)
        assert bd.LAUNCHES == before + 1
        want = bd.build_tables_reference(cd, rows, k, d, p0=s * m)
        torch.cuda.synchronize()
        for g, w, name in zip(got, want, ("counts", "bitmaps", "dollar_pos")):
            assert g.dtype == w.dtype and g.shape == w.shape, (s, name)
            assert torch.equal(g, w), (s, name)


@pytest.mark.parametrize("n,k,d", [(3001, 3, 192), (200_000, 2, 64)])
def test_sharded_build_on_card_matches_one_device(cuda, n, k, d):
    """The sharded build over two shards of one card (the mesh suffix sort,
    K7 a shard, the finish through the collectives) equal to the
    one-device build on the card, host tables and ``ShardTables`` alike, and
    its locate tables equal to the one-device locate tables; K7 launched
    once a shard a table set."""
    from tpufm_torch.engine.tables import shard_tables
    from tpufm_torch.index import builder_device as bd
    from tpufm_torch.index.builder_sharded import build_index_sharded, build_locate_sharded
    from tpufm_torch.index.sa_sharded import suffix_array_sharded
    from tpufm_torch.parallel import Mesh

    mesh = Mesh([cuda] * 2)
    codes = np.random.default_rng(n).integers(0, 4, size=n, dtype=np.uint8)
    np.testing.assert_array_equal(suffix_array_sharded(codes, mesh), suffix_array(codes))
    cfg = IndexConfig(k=k, d=d)
    one = bd.build_index_device(codes, cfg, device=cuda)
    before = bd.LAUNCHES
    got = build_index_sharded(codes, cfg, mesh)
    assert bd.LAUNCHES == before + 2
    for f in ("occ", "bitmaps", "dollar_pos", "dollar_base"):
        a, b = getattr(got, f), getattr(one, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    tables, want = build_index_sharded(codes, cfg, mesh, return_host=False), shard_tables(one, 2)
    assert tables.e_local == want.e_local and np.array_equal(tables.dollar, want.dollar)
    for a, b in zip(tables.occ + tables.bitmaps, want.occ + want.bitmaps):
        assert a.device.type == "cuda" and np.array_equal(a.cpu().numpy().view(np.uint32), b)
    loc, one_loc = build_locate_sharded(codes, 8, d, mesh), bd.build_locate_device(codes, 8, d, device=cuda)
    for f in ("samples", "mark_words", "mark_rank"):
        a, b = getattr(loc, f), getattr(one_loc, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("width", ["host", "device"])
@pytest.mark.parametrize("D", [1, 3, 4])
@pytest.mark.parametrize("k,d", [(1, 32), (2, 64), (3, 192), (4, 96)])
def test_lf_answer_owned_kernel_matches_plain(cuda, k, d, D, width):
    """K9 on every shard of a table cut D ways (e_local not dividing it for
    D = 3, 4) against its plain version, on the edge-case requests of
    chip_smoke phase 19(e): random ends, zero rows, the '$' blocks, shard
    edges, the padded rows past the table, owners past the mesh; host-width
    plane rows (the word path) and the engines' rows padded to 4 words. The
    owners' answers summed over the shards are the split round's."""
    import chip_smoke
    from tpufm_torch.bitops import from_u32_bits
    from tpufm_torch.engine.tables import shard_tables

    _, index = _index(k, d, 20_000)
    t = shard_tables(index, D)
    dollar = index_dollar(index)
    n = 4099
    req_h = chip_smoke.k9_edge_requests(np.random.default_rng(10 * k + D), index.bwtsize, k, d, dollar, D,
                                        t.e_local, n)
    req = torch.from_numpy(req_h).to(cuda)
    dol = torch.from_numpy(dollar).to(cuda)
    total = torch.zeros(req.shape[0], dtype=torch.int64, device=cuda)
    for s in range(D):
        if width == "device":
            bitmaps = _rows(t.bitmaps[s], cuda)
        else:
            bitmaps = torch.from_numpy(np.ascontiguousarray(t.bitmaps[s]).view(np.int32)).to(cuda)
        occ = torch.from_numpy(np.ascontiguousarray(t.occ[s]).view(np.int32)).to(cuda)
        before = lf_mod.OWNED_LAUNCHES
        got = lf_mod.lf_answer_owned(bitmaps, occ, req, s, t.e_local, dol, k, d)
        torch.cuda.synchronize()
        assert lf_mod.OWNED_LAUNCHES == before + 1
        assert torch.equal(got, lf_mod.lf_answer_owned_reference(bitmaps, occ, req, s, t.e_local, dol, k, d))
        total += from_u32_bits(got)
    ends, code = from_u32_bits(req[:n, 2]), from_u32_bits(req[:n, 1])
    fused = torch.from_numpy(tables_from_index(index).entries.view(np.int32)).to(cuda)
    assert torch.equal(total[:n] & 0xFFFFFFFF, lf_mod.lf_round_reference(fused, ends, code, dol, k, d))
    empty = req[:0]
    assert lf_mod.lf_answer_owned(bitmaps, occ, empty, 0, t.e_local, dol, k, d).shape == (0,)


def _owned_requests(rng, bwtsize: int, d: int, e_local: int, shard: int, share: str, n: int) -> np.ndarray:
    """int32 [n, 3] requests (block, code, interval; uint32 bits) of which
    shard ``shard`` owns none, the first of every 32 (one lane a warp), a
    random quarter, or all; the others' blocks lie anywhere else in the
    table."""
    E = bwtsize // d + 1
    mine = np.arange(shard * e_local, min((shard + 1) * e_local, E))
    rest = np.setdiff1d(np.arange(E), mine)
    own = {"none": np.zeros(n, bool), "one a warp": np.arange(n) % 32 == 0,
           "quarter": rng.random(n) < 0.25, "all": np.ones(n, bool)}[share]
    block = np.where(own, rng.choice(mine, size=n), rng.choice(rest, size=n))
    iv = np.minimum(block * d + rng.integers(0, d, size=n), bwtsize)
    return np.stack([iv // d, rng.integers(0, 4**3, size=n), iv], axis=1).astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("width", ["host", "device"])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n,d", [(1, 192), (31, 192), (33, 192), (4099, 192), ((1 << 17) + 1, 192),
                                 ((1 << 20) + 33, 192), ((1 << 20) + 33, 160)])
@pytest.mark.parametrize("share", ["none", "one a warp", "quarter", "all"])
def test_lf_answer_owned_kernel_owned_shares(cuda, share, n, d, offset, width):
    """K9 on shard 1 of a four-way split (k=3) where it owns none of the
    requests, one a warp, a quarter or all of them (its warps that own
    nothing write zeros and stop; the others stage only the owned rows); n
    off a multiple of 32; the stream as a view at row ``offset`` of a
    larger tensor (offset 1: a base 12 bytes off 16, as a ring half at an
    odd row, which the kernel loads by words); host-width plane rows and the
    engines' padded rows. From 2^20 + 33 requests the H100 takes two a lane
    (from about 608k at d = 160 and 192): then every two groups that own
    more than 32 rows take a second batch, the last warp holds 33 of its 64
    requests, and at d = 160 the count is the word path's (no 16-byte
    vectors) on host-width rows of 30 words, copied by 4-byte units.
    Bit-identical to the plain version."""
    from tpufm_torch.engine.tables import shard_tables

    k, s = 3, 1
    _, index = _index(k, d, 20_000)
    t = shard_tables(index, 4)
    rng = np.random.default_rng(n + 3 * offset + len(share))
    req_h = _owned_requests(rng, index.bwtsize, d, t.e_local, s, share, n)
    buf = torch.zeros((n + offset, 3), dtype=torch.int32, device=cuda)
    buf[offset:] = torch.from_numpy(req_h).to(cuda)
    req = buf[offset:]
    assert req.is_contiguous() and (req.data_ptr() % 16 == 0) == (offset == 0)
    if width == "device":
        bitmaps = _rows(t.bitmaps[s], cuda)
    else:
        bitmaps = torch.from_numpy(np.ascontiguousarray(t.bitmaps[s]).view(np.int32)).to(cuda)
    occ = torch.from_numpy(np.ascontiguousarray(t.occ[s]).view(np.int32)).to(cuda)
    dol = torch.from_numpy(index_dollar(index)).to(cuda)
    before = lf_mod.OWNED_LAUNCHES
    got = lf_mod.lf_answer_owned(bitmaps, occ, req, s, t.e_local, dol, k, d)
    torch.cuda.synchronize()
    assert lf_mod.OWNED_LAUNCHES == before + 1
    want = lf_mod.lf_answer_owned_reference(bitmaps, occ, req, s, t.e_local, dol, k, d)
    assert torch.equal(got, want)
    owned = (req[:, 0].to(torch.int64) // t.e_local == s).cpu().numpy()
    assert owned.sum() == {"none": 0, "one a warp": -(-n // 32), "all": n}.get(share, owned.sum())
    assert not bool(got[torch.from_numpy(~owned).to(cuda)].any())
