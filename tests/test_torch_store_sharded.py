"""The per-shard store (tpufm_torch.host.formats ``save_store_sharded`` and
``load_store_sharded``) against tpufm's (tpufm/index/store.py:111, :167)
on the same text: the port's files from its sharded build on 1, 4 and 8
CPU shards byte-identical to tpufm's from its own on as many virtual CPU
devices (tests/conftest.py), ``meta.json`` equal as JSON; each package
loading the other's store and searching it to the same intervals; the
one-shard store (tests/test_store.py:195); and the refusal of a mesh of
another size, word for word. Words and intervals are integers and compare
exactly (tolerance 0)."""

import json

import numpy as np
import pytest

from tpufm.config import IndexConfig as JaxIndexConfig
from tpufm.index.builder_sharded import build_index_sharded as jax_build_index_sharded
from tpufm.index.store import load_store_sharded as jax_load_store_sharded
from tpufm.index.store import save_store_sharded as jax_save_store_sharded
from tpufm.parallel import ShardedIndexEngine as JaxSharded
from tpufm.parallel.mesh import make_mesh as jax_make_mesh
from tpufm_torch.engine.tables import ShardTables
from tpufm_torch.host.formats import load_store_sharded, save_store_sharded
from tpufm_torch.host.index import IndexConfig
from tpufm_torch.index.builder_sharded import build_index_sharded
from tpufm_torch.parallel import ShardedIndexEngine
from tpufm_torch.parallel.mesh import make_mesh

N = 5000


def _codes():
    return np.random.default_rng(N).integers(0, 4, size=N, dtype=np.uint8)


def _reads(codes, L=24, B=96):
    return np.stack([codes[s:s + L] for s in np.random.default_rng(2).integers(0, N - L, B)])


@pytest.mark.parametrize("k,d,D", [(2, 64, 4), (3, 192, 8), (1, 32, 4), (2, 64, 1)])
def test_store_sharded_bytes_and_round_trip(tmp_path, k, d, D):
    """Every shard file, ``dollar_pos.npy`` and ``dollar_base.npy`` byte for
    byte tpufm's, ``meta.json`` equal as JSON; the port loads its own store
    and tpufm's back into the tables it saved, each package searches the
    other's store to the same intervals, and tpufm's loader reads the
    port's."""
    codes = _codes()
    tables = build_index_sharded(codes, IndexConfig(k=k, d=d), make_mesh(D, device="cpu"), return_host=False)
    ours = save_store_sharded(tmp_path / "torch", tables)
    jmesh = jax_make_mesh(D)
    theirs = jax_save_store_sharded(
        tmp_path / "jax", jax_build_index_sharded(codes, JaxIndexConfig(k=k, d=d), jmesh, return_host=False))
    assert ours.name == "torch.tpufm" and sorted(p.name for p in ours.iterdir()) == sorted(
        p.name for p in theirs.iterdir())
    assert len(list(ours.glob("occ.shard*.npy"))) == D
    for p in theirs.iterdir():
        if p.name == "meta.json":
            assert json.loads((ours / p.name).read_text()) == json.loads(p.read_text())
        else:
            assert (ours / p.name).read_bytes() == p.read_bytes(), p.name
    mesh = make_mesh(D, device="cpu")
    reads = _reads(codes)
    want = np.asarray(JaxSharded(jax_load_store_sharded(theirs, jmesh), jmesh).search(reads))
    assert np.array_equal(np.asarray(JaxSharded(jax_load_store_sharded(ours, jmesh), jmesh).search(reads)), want)
    for root in (ours, theirs):
        back = load_store_sharded(root, mesh)
        assert isinstance(back, ShardTables) and back.e_local == tables.e_local and back.bwtsize == N + 1
        assert np.array_equal(back.dollar, tables.dollar)
        for a, b in zip(back.occ + back.bitmaps, tables.occ + tables.bitmaps):
            assert a.dtype == b.dtype and a.shape == b.shape and bool((a == b).all())
        assert np.array_equal(ShardedIndexEngine(back, mesh).search(reads), want)


def test_store_sharded_refusals(tmp_path):
    """A mesh of another size, a store of another kind and host tables:
    tpufm's errors, word for word."""
    codes = _codes()
    tables = build_index_sharded(codes, IndexConfig(k=2, d=64), make_mesh(4, device="cpu"), return_host=False)
    root = save_store_sharded(tmp_path / "s", tables)
    with pytest.raises(ValueError) as jax_err:
        jax_load_store_sharded(root, jax_make_mesh(2))
    with pytest.raises(ValueError) as torch_err:
        load_store_sharded(root, make_mesh(2, device="cpu"))
    assert str(torch_err.value) == str(jax_err.value) and "store has 4 shards; mesh has 2" in str(jax_err.value)
    meta = json.loads((root / "meta.json").read_text())
    (root / "meta.json").write_text(json.dumps({**meta, "kind": "kstep"}))
    with pytest.raises(ValueError) as jax_err:
        jax_load_store_sharded(root, jax_make_mesh(4))
    with pytest.raises(ValueError) as torch_err:
        load_store_sharded(root, make_mesh(4, device="cpu"))
    assert str(torch_err.value) == str(jax_err.value)
    with pytest.raises(TypeError, match="expects row-sharded tables"):
        save_store_sharded(tmp_path / "h", build_index_sharded(codes, IndexConfig(k=2, d=64),
                                                               make_mesh(4, device="cpu")))
