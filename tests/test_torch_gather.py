"""The port's gathered-row path against the JAX package's: the row gather
(tpufm_torch.engine.row_gather) against make_dma_gather in interpret mode
and jnp.take, the LF round on gathered rows (lf_round_rows) against
make_lf_round in interpret mode, and SearchEngine(gather="dma") against
XLAEngine(gather="dma") and the oracle. Inputs are made with numpy from a
seed and handed to both sides; results are integers and compare exactly
(tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufm.config import IndexConfig
from tpufm.engine.dma_gather import make_dma_gather
from tpufm.engine.oracle import search_oracle
from tpufm.engine.pallas_kernel import make_lf_round
from tpufm.engine.xla import XLAEngine
from tpufm.index.builder import build_index
from tpufm.io.genreads import generate_reads
from tpufm_torch import SearchEngine
from tpufm_torch.engine import lf_round as lf_mod
from tpufm_torch.engine import row_gather as rg_mod
from tpufm_torch.engine import search as search_mod
from tpufm_torch.engine.tables import tables_from_index


def _table(rng, E, W):
    return rng.integers(0, 2**32, (E, W), dtype=np.uint32)


#: the kernel's tile at W=128
_T128 = rg_mod.tile_rows(128)


# N not a multiple of the TPU's 1024-entry chunk, nor of the kernel's tile
@pytest.mark.parametrize("N", [1500, _T128 + 1, 5 * _T128 - 1])
def test_row_gather_reference_matches_dma_gather(rng, N):
    E, W = 500, 128
    assert N % _T128 and N % 1024
    table = _table(rng, E, W)
    idx = rng.integers(0, E, N, dtype=np.int32)
    want = np.asarray(make_dma_gather(E, W, interpret=True)(jnp.asarray(table), jnp.asarray(idx)))
    np.testing.assert_array_equal(want, np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(idx), axis=0)))
    t, i = torch.from_numpy(table.view(np.int32)), torch.from_numpy(idx.astype(np.int64))
    np.testing.assert_array_equal(rg_mod.row_gather_reference(t, i).numpy().view(np.uint32), want)
    np.testing.assert_array_equal(rg_mod.row_gather(t, i).numpy().view(np.uint32), want)


@pytest.mark.parametrize("W,table_ptr,out_ptr,path", [
    (100, 0, 0, "int4"), (128, 16, 32, "int4"), (4, 48, 16, "int4"),
    (6, 0, 0, "word"), (100, 4, 0, "word"), (1, 0, 0, "word"), (3, 12, 16, "word"),
    (100, 0, 4, "word"), (6, 0, 8, "word"), (128, 4, 12, "word"),
])
def test_copy_path(W, table_ptr, out_ptr, path):
    assert rg_mod.copy_path(W, table_ptr, out_ptr) == path


@pytest.mark.parametrize("W", [1, 3, 4, 6, 8, 100, 128, 200, 4095, 4096, 5000, 1 << 20])
def test_tile_rows(W):
    rows = rg_mod.tile_rows(W)
    words = rg_mod.THREADS * rg_mod.UNROLL * 4
    assert 1 <= rows <= rg_mod.MAX_TILE_ROWS
    # a tile fills at most one pass of the block, unless one row is wider,
    # and more than half a pass unless MAX_TILE_ROWS caps it
    assert rows * W <= words or rows == 1
    assert rows * W > words // 2 or rows in (1, rg_mod.MAX_TILE_ROWS)


def test_tile_rows_at_the_search_and_word_shapes():
    assert rg_mod.tile_rows(100) == 40  # 1000 of a pass's 1024 units
    assert rg_mod.tile_rows(128) == 32
    assert rg_mod.tile_rows(6) == 682


@pytest.mark.parametrize("n", [1, 39, 40, 41, 40 * 132 * 6, 40 * 132 * 6 + 1, 2 << 20])
def test_grid_blocks(n):
    sms, rows = 132, rg_mod.tile_rows(100)
    blocks = rg_mod.grid_blocks(n, rows, sms)
    tiles = -(-n // rows)
    assert 1 <= blocks <= min(tiles, sms * rg_mod.BLOCKS_PER_SM)
    assert blocks == min(tiles, sms * rg_mod.BLOCKS_PER_SM)
    if n == 2 << 20:  # the search's 2M rows: each block loops over many tiles
        assert tiles > 60 * blocks


@pytest.mark.parametrize("W,table_ptr,out_ptr", [(100, 0, 0), (6, 0, 0), (6, 4, 8), (128, 0, 4)])
def test_plan(W, table_ptr, out_ptr):
    n, sms = 2 << 20, 132
    p = rg_mod.plan(n, W, table_ptr, out_ptr, sms)
    assert p.path == rg_mod.copy_path(W, table_ptr, out_ptr)
    assert p.tile_rows == rg_mod.tile_rows(W)
    assert p.blocks == rg_mod.grid_blocks(n, p.tile_rows, sms)
    assert p.path in rg_mod.PATHS


def _emulate(plan, table, idx):
    """The kernel's copy as row_gather.cu runs it, in numpy: blocks loop
    over tiles of plan.tile_rows rows; the tile's output is one run whose
    element f (a 16-byte unit or a word) is element c of the tile's row r,
    r and c stepped by THREADS elements from the thread's first element as
    the kernel steps them. Each output word must be written exactly once."""
    E, W = table.shape
    n = idx.shape[0]
    out = np.zeros(n * W, dtype=np.uint32)
    written = np.zeros(n * W, dtype=np.int64)
    flat = table.reshape(-1)
    unit = 4 if plan.path == "int4" else 1  # words an element
    per_row = W // unit
    tiles = -(-n // plan.tile_rows)
    dq, dr = divmod(rg_mod.THREADS, per_row)
    for b in range(plan.blocks):
        for tile in range(b, tiles, plan.blocks):
            first = tile * plan.tile_rows
            rows = min(plan.tile_rows, n - first)
            src = np.clip(idx[first:first + rows], 0, E - 1) * per_row
            total = rows * per_row
            base = np.arange(min(rg_mod.THREADS, total))  # each thread's first element
            r, c = base // per_row, base % per_row
            while base.size:
                keep = base < total
                base, r, c = base[keep], r[keep], c[keep]
                for k in range(unit):
                    at = (first * W) + unit * base + k
                    out[at] = flat[unit * (src[r] + c) + k]
                    written[at] += 1
                base = base + rg_mod.THREADS
                r, c = r + dq, c + dr
                r, c = np.where(c >= per_row, r + 1, r), np.where(c >= per_row, c - per_row, c)
    assert (written == 1).all()
    return out.reshape(n, W)


@pytest.mark.parametrize("path,W", [("int4", 100), ("int4", 8), ("int4", 4), ("int4", 2048),
                                    ("word", 6), ("word", 1), ("word", 3), ("word", 100), ("word", 300),
                                    ("word", 5000)])
def test_tiles_cover_every_row_once(rng, path, W):
    E = 50
    table = _table(rng, E, W)
    for n in (1, 7, 1000, 4099):
        idx = rng.integers(-3, E + 3, n)
        rows = rg_mod.tile_rows(W)
        plan = rg_mod.Plan(path, rows, rg_mod.grid_blocks(n, rows, sms=2))
        np.testing.assert_array_equal(_emulate(plan, table, idx), table[np.clip(idx, 0, E - 1)])


@pytest.mark.parametrize("W", [6, 100])
def test_row_gather_on_cpu_clamps_like_a_jax_gather(rng, W):
    E = 300
    table = _table(rng, E, W)
    # out-of-range rows on both sides, clamped into the table (the engine's
    # rows come from a JAX gather, which clamps past the end)
    idx = np.concatenate([[-3, -1, 0, E - 1, E, E + 5], rng.integers(0, E, 1000)]).astype(np.int64)
    want = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(idx), axis=0, mode="clip"))
    np.testing.assert_array_equal(want, table[np.clip(idx, 0, E - 1)])
    t, i = torch.from_numpy(table.view(np.int32)), torch.from_numpy(idx)
    before = rg_mod.LAUNCHES
    got = rg_mod.row_gather(t, i)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    out = torch.full((idx.shape[0], W), 7, dtype=torch.int32)
    assert rg_mod.row_gather(t, i, out=out) is out
    np.testing.assert_array_equal(out.numpy().view(np.uint32), want)
    assert rg_mod.LAUNCHES == before  # the plain path launches nothing


def test_row_gather_checks_its_arguments():
    t = torch.zeros((4, 8), dtype=torch.int32)
    i = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(ValueError, match="int64"):
        rg_mod.row_gather(t, i.to(torch.int32))
    with pytest.raises(ValueError, match="int32"):
        rg_mod.row_gather(t.to(torch.int64), i)
    with pytest.raises(ValueError, match="out must be"):
        rg_mod.row_gather(t, i, out=torch.empty((3, 7), dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        rg_mod.row_gather(t[:, ::2], i)


@pytest.mark.parametrize("pad", [0, 28])
@pytest.mark.parametrize("k,d", [(1, 192), (2, 64), (3, 192)])
def test_lf_round_rows_matches_pallas(rng, k, d, pad):
    codes = rng.integers(0, 4, size=(1300 // d) * d - 1, dtype=np.uint8)
    index = build_index(codes, IndexConfig(k=k, d=d), sa_method="doubling")
    t = tables_from_index(index)
    n = 640  # a multiple of the tile: the Pallas wrapper pads only unpadded rows
    iv = rng.integers(0, index.bwtsize + 1, size=n)
    code = rng.integers(0, 4**k, size=n)
    # the '$' corrections: each '$' position and one past it, with its k-mer
    for j, (pos, base) in enumerate(zip(index.dollar_pos, index.dollar_base)):
        iv[2 * j: 2 * j + 2] = [pos, pos + 1]
        code[2 * j: 2 * j + 2] = base
    iv[-1] = index.bwtsize
    iv, code = iv.astype(np.uint32), code.astype(np.uint32)
    rows = t.entries[np.minimum(iv // d, t.entries.shape[0] - 1)]
    rows = np.concatenate([rows, np.zeros((n, pad), np.uint32)], axis=1)

    want = make_lf_round(k, d, tile=64, interpret=True)(
        jnp.asarray(rows), jnp.asarray(iv), jnp.asarray(code), jnp.asarray(t.dollar)
    )
    args = [torch.from_numpy(a) for a in (iv.astype(np.int64), code.astype(np.int64), t.dollar.astype(np.int64))]
    got = lf_mod.lf_round_rows(torch.from_numpy(rows.view(np.int32)), *args, k, d)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the same round on the table itself, K1's fused entry
    fused = lf_mod.lf_round(torch.from_numpy(t.entries.view(np.int32)), *args, k, d)
    np.testing.assert_array_equal(fused.numpy(), got.numpy())
    with pytest.raises(ValueError, match="rows for"):
        lf_mod.lf_round_rows(torch.from_numpy(rows[1:].view(np.int32)), *args, k, d)


@pytest.fixture(scope="module")
def dma_case():
    """The cases of tests/test_dma_gather.py's engine test: 20,000 bases,
    k=2 d=64, 64 sampled 24 bp reads and 32 random ones."""
    rng = np.random.default_rng(1234)
    codes = rng.integers(0, 4, size=20000, dtype=np.uint8)
    index = build_index(codes, IndexConfig(k=2, d=64))
    reads = generate_reads(codes, 24, 64, seed=5)
    misses = rng.integers(0, 4, size=(32, 24), dtype=np.uint8)
    queries = np.concatenate([reads, misses])
    return index, queries, search_oracle(index, queries)


@pytest.mark.parametrize("lut_m", [0, 4])
def test_search_engine_dma_matches_xla_dma_and_oracle(dma_case, monkeypatch, lut_m):
    index, queries, expect = dma_case
    want = XLAEngine(index, gather="dma", lut_m=lut_m).search(queries)
    np.testing.assert_array_equal(want, expect)

    calls = {"gather": 0, "rows": 0}

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(search_mod, "row_gather", spy("gather", rg_mod.row_gather))
    monkeypatch.setattr(search_mod, "lf_round_rows", spy("rows", lf_mod.lf_round_rows))
    engine = SearchEngine(index, "cpu", lut_m=lut_m, gather="dma")
    calls.update(gather=0, rows=0)  # the LUT build takes the default step
    got = engine.search(queries, wave=40)
    np.testing.assert_array_equal(got, want)
    rounds = (24 - lut_m) // 2 * 3  # three waves of 40, 40 and 16 reads
    assert calls == {"gather": rounds, "rows": rounds}
    np.testing.assert_array_equal(engine.search(queries, step=lf_mod.lf_round_reference), want)


def test_unknown_gather_raises(dma_case):
    with pytest.raises(ValueError, match="unknown gather"):
        SearchEngine(dma_case[0], "cpu", gather="xla")
