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
oracles. Intervals, positions, distances and table words are integers and
compare exactly (tolerance 0).
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
from tpufm_torch.engine.tables import tables_from_index
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
