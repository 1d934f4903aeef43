"""The sharded build (tpufm_torch.index.builder_sharded) against tpufm's
(tpufm/index/builder_sharded.py) and the host builders on the same texts,
the port on 4 and 8 CPU shards and tpufm on as many of its virtual CPU
devices (tests/conftest.py): ``build_index_sharded`` at k 1-4 and d 32, 64
and 192, on texts where the entry count E is a multiple of the shard count
and where it is not, where n + 1 is a multiple of d, and so short that
shards hold nothing but pads; its ``return_host=False`` tables against
``shard_tables`` of the host build and tpufm's sharded engine's split, and
searched by ``ShardedIndexEngine`` to tpufm's intervals;
``build_locate_sharded`` against tpufm's and the host's; K7's slice form
(its plain version on CPU tensors) against the whole build's. Tables are
integers and compare exactly (tolerance 0)."""

import functools

import numpy as np
import pytest
import torch

from tpufm.config import IndexConfig as JaxIndexConfig
from tpufm.index.builder_sharded import build_index_sharded as jax_build_index_sharded
from tpufm.index.builder_sharded import build_locate_sharded as jax_build_locate_sharded
from tpufm.parallel import ShardedIndexEngine as JaxSharded
from tpufm.parallel.mesh import make_mesh as jax_make_mesh
from tpufm_torch.engine.tables import shard_tables, shards_from_jax
from tpufm_torch.host.index import IndexConfig, build_index
from tpufm_torch.host.locate import build_locate
from tpufm_torch.index.builder_device import build_tables, build_tables_reference
from tpufm_torch.index.builder_sharded import build_index_sharded, build_locate_sharded, table_rows
from tpufm_torch.index.sa_sharded import suffix_array_sharded_arr
from tpufm_torch.parallel import ShardedIndexEngine
from tpufm_torch.parallel import collectives as coll
from tpufm_torch.parallel.mesh import make_mesh

FIELDS = ("occ", "bitmaps", "dollar_pos", "dollar_base")


@functools.lru_cache(maxsize=None)
def _codes(n: int) -> np.ndarray:
    return np.random.default_rng(n).integers(0, 4, size=n, dtype=np.uint8)


@functools.lru_cache(maxsize=None)
def _jax_index(n: int, k: int, d: int, D: int):
    return jax_build_index_sharded(_codes(n), JaxIndexConfig(k=k, d=d), jax_make_mesh(D))


def _same(got, want):
    for f in FIELDS:
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f


# E % D == 0 at (2, 64, 2047) on 4 and 8 shards (E = 32) and (3, 192, 3071) on 4 (E = 16); (n + 1) % d == 0
# at 2047 / 64, 3071 / 192 and 4095 / 32; n = 20 leaves most shards pads only
@pytest.mark.parametrize("k,d,n,D", [(1, 32, 4095, 4), (1, 64, 20, 8), (2, 64, 2047, 4), (2, 64, 2047, 8),
                                     (2, 192, 5000, 8), (3, 192, 3071, 4), (3, 32, 3001, 8), (3, 64, 3001, 4),
                                     (4, 64, 6000, 4)])
def test_build_index_sharded_matches_tpufm(k, d, n, D):
    """The host tables of the port's sharded build equal tpufm's sharded
    build and the port's host build, dtypes included."""
    cfg = IndexConfig(k=k, d=d)
    got = build_index_sharded(_codes(n), cfg, make_mesh(D, device="cpu"))
    _same(got, _jax_index(n, k, d, D))
    _same(got, build_index(_codes(n), cfg))


@pytest.mark.parametrize("D", [4, 8])
@pytest.mark.parametrize("k,d,n", [(2, 64, 2047), (3, 192, 3001), (1, 32, 20)])
def test_sharded_tables_match_split_and_tpufm_engine(k, d, n, D):
    """``return_host=False``: the ``ShardTables`` of e_local = ceil((E+1) /
    D) rows a shard equal ``shard_tables`` of the host build and tpufm's
    engine's split of its own device-resident sharded build (the build's
    ceil(E / D) blocks a shard moved to the engine's rows between the
    shards, the sentinel row on its owner); ``ShardedIndexEngine`` on them
    gives tpufm's intervals on every routing."""
    codes = _codes(n)
    mesh = make_mesh(D, device="cpu")
    tables = build_index_sharded(codes, IndexConfig(k=k, d=d), mesh, return_host=False)
    host = build_index(codes, IndexConfig(k=k, d=d))
    jeng = JaxSharded(jax_build_index_sharded(codes, JaxIndexConfig(k=k, d=d), jax_make_mesh(D), return_host=False),
                      jax_make_mesh(D))
    for want in (shard_tables(host, D), shards_from_jax(jeng)):
        assert tables.e_local == want.e_local and np.array_equal(tables.dollar, want.dollar)
        for a, b in zip(tables.occ + tables.bitmaps, want.occ + want.bitmaps):
            assert a.dtype == torch.int32 and np.array_equal(a.numpy().view(np.uint32), b)
    rng = np.random.default_rng(3)
    L = 12 - 12 % k
    reads = np.stack([codes[s:s + L] for s in rng.integers(0, n - L, 64)]) if n > L else codes[None, :L]
    want = np.asarray(jeng.search(reads))
    for routing in ("allgather", "ring", "a2a"):
        assert np.array_equal(ShardedIndexEngine(tables, mesh, routing=routing).search(reads), want), routing


@pytest.mark.parametrize("D", [4, 8])
@pytest.mark.parametrize("s,d,n", [(8, 32, 5000), (16, 64, 4095), (32, 192, 3001), (4, 64, 30)])
def test_build_locate_sharded_matches_tpufm(s, d, n, D):
    """``build_locate_sharded`` (one sort shared with its k=1 index) equals
    tpufm's and the host's: the samples (each shard's marked rows in shard
    order against tpufm's compaction by a global sort), mark words and
    mark rank, and the k=1 index."""
    codes = _codes(n)
    got = build_locate_sharded(codes, sample_rate=s, d=d, mesh=make_mesh(D, device="cpu"))
    for want in (jax_build_locate_sharded(codes, sample_rate=s, d=d, mesh=jax_make_mesh(D)),
                 build_locate(codes, sample_rate=s, d=d)):
        for f in ("samples", "mark_words", "mark_rank"):
            a, b = getattr(got, f), np.asarray(getattr(want, f))
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        _same(got.lf1, want.lf1)


def test_one_sort_serves_every_table_set():
    """``sa_dev``: one sharded sort for the index, its k=1 tail and the
    locate tables, the same arrays as sorting for each; a sort of another
    mesh size is refused."""
    codes = _codes(3001)
    mesh = make_mesh(4, device="cpu")
    order = suffix_array_sharded_arr(codes, mesh)
    _same(build_index_sharded(codes, IndexConfig(k=3, d=64), mesh, sa_dev=order),
          build_index(codes, IndexConfig(k=3, d=64)))
    _same(build_index_sharded(codes, IndexConfig(k=1, d=64), mesh, sa_dev=order),
          build_index(codes, IndexConfig(k=1, d=64)))
    loc = build_locate_sharded(codes, 8, 64, mesh, sa_dev=order)
    assert np.array_equal(loc.samples, build_locate(codes, 8, 64).samples)
    with pytest.raises(ValueError, match="sa_dev has 4 shards"):
        build_index_sharded(codes, IndexConfig(k=3, d=64), make_mesh(2, device="cpu"), sa_dev=order)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_build_tables_slices_join_to_the_whole(k):
    """K7's plain version on each shard's rows (``p0 = s * m``, the last
    shard's pads read as k-mer 0) gives the whole build's planes, its
    counts and its '$' rows (the whole pad blocks past them aside); slices
    that are not whole blocks, or an offset off a block, are refused."""
    n, d, D = 5000, 64, 4
    codes = torch.from_numpy(_codes(n))
    order = suffix_array_sharded_arr(_codes(n), make_mesh(D, device="cpu"))
    m = table_rows(n + 1, d, D)
    sa = coll.relayout(order, n + 1, m)
    whole = build_tables_reference(codes, torch.cat(sa)[:n + 1], k, d)
    parts = [build_tables_reference(codes, x, k, d, p0=s * m, big=n + 1) for s, x in enumerate(sa)]
    E = whole[0].shape[0]
    assert torch.equal(torch.cat([p[0] for p in parts])[:E], whole[0])
    assert torch.equal(torch.cat([p[1][:-1] for p in parts])[:E], whole[1][:E])
    assert torch.equal(sum(p[2] for p in parts), whole[2])
    with pytest.raises(ValueError, match="whole blocks"):
        build_tables(codes, sa[0][:100], k, d)
    with pytest.raises(ValueError, match="multiple of d"):
        build_tables(codes, sa[1], k, d, p0=32)
