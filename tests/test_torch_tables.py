"""The port's tables against the JAX engine's state: fused rows, the bridge
tables_from_jax(XLAEngine.tables), the prefix LUT and its .npz cache, which
both engines read and write. Inputs are made with numpy from a seed;
tables and intervals are integers and compare exactly (tolerance 0)."""

import os

import numpy as np
import pytest

from tpufm.config import IndexConfig
from tpufm.engine import xla
from tpufm.engine.oracle import search_oracle
from tpufm.engine.xla import SearchLocateEngine, XLAEngine, build_locate_tables
from tpufm.index.builder import build_index, derive_tail
from tpufm.index.locate import build_locate
from tpufm.index.suffix_array import suffix_array
from tpufm_torch import SearchEngine, tables_from_index, tables_from_jax
from tpufm_torch.engine import tables as tables_mod

_D = {1: 32, 2: 64, 3: 192}


def _mk(rng, k, d, n=1200):
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    return codes, build_index(codes, IndexConfig(k=k, d=d), sa_method="doubling")


def _queries(rng, codes, L, n=64):
    starts = rng.integers(0, len(codes) - L, size=n)
    return np.stack([codes[s : s + L] for s in starts])


@pytest.mark.parametrize("k", [1, 2, 3])
def test_fused_entries_match_jax(rng, k):
    _, index = _mk(rng, k, _D[k])
    np.testing.assert_array_equal(
        tables_mod.build_fused_entries(index), xla.build_fused_entries(index)
    )


@pytest.mark.parametrize("k", [1, 2, 3])
def test_tables_from_jax_give_identical_results(rng, k):
    codes, index = _mk(rng, k, _D[k])
    tail = derive_tail(index) if k > 1 else None
    L = 6 * k + 1 if tail is not None else 6 * k
    jax_engine = XLAEngine(index, lut_m=2 * k, tail_index=tail)
    t = tables_from_jax(jax_engine.tables)
    own = tables_from_index(index, tail)
    assert (t.k, t.d, t.bwtsize, t.tail_d) == (own.k, own.d, own.bwtsize, own.tail_d)
    np.testing.assert_array_equal(t.entries, own.entries)
    np.testing.assert_array_equal(t.dollar, own.dollar)
    if tail is not None:
        np.testing.assert_array_equal(t.tail_entries, own.tail_entries)
        np.testing.assert_array_equal(t.tail_dollar, own.tail_dollar)
    queries = _queries(rng, codes, L)
    engine = SearchEngine(t, "cpu")
    assert engine.lut_m == 2 * k
    np.testing.assert_array_equal(engine.search(queries), jax_engine.search(queries))


@pytest.mark.parametrize(
    "engine_kw,given_d",
    [
        ({"pad_words": 128}, False),
        ({"pad_words": 128}, True),
        ({"gather": "dma", "lut_m": 4}, False),
        ({"gather": "dma", "lut_m": 4}, True),
    ],
)
def test_tables_from_jax_rejects_padded_rows(rng, engine_kw, given_d):
    """Padded rows (pad_words, or gather="dma"'s 128-word rows) are refused
    without the sample distance, and with it give the JAX engine's results
    on both of the port's gather paths."""
    codes, index = _mk(rng, 2, 64)
    tail = derive_tail(index)
    jax_engine = XLAEngine(index, tail_index=tail, **engine_kw)
    assert jax_engine.tables["entries"].shape[1] == 128
    if not given_d:
        with pytest.raises(ValueError, match="pass d"):
            tables_from_jax(jax_engine.tables)
        return
    t = tables_from_jax(jax_engine.tables, d=64)
    own = tables_from_index(index, tail)
    assert (t.k, t.d, t.bwtsize, t.tail_d) == (own.k, own.d, own.bwtsize, own.tail_d)
    np.testing.assert_array_equal(t.entries, own.entries)
    queries = _queries(rng, codes, 25)  # 25 % 2: one k=1 tail round
    want = jax_engine.search(queries)
    np.testing.assert_array_equal(want, search_oracle(index, queries, tail_index=tail))
    for gather in ("fused", "dma"):
        engine = SearchEngine(t, "cpu", gather=gather)
        assert engine.lut_m == engine_kw.get("lut_m", 0)
        np.testing.assert_array_equal(engine.search(queries), want)


@pytest.mark.parametrize("loc_d", [32, 64, 96])
def test_tables_from_jax_takes_the_locate_rows_tail(loc_d):
    """The JAX search+locate state carries the fused locate rows (3*nb + 5
    words) as its k=1 tail table (xla.py:1183-1189). Read by width alone
    they pass for plain k=1 rows of another d (d=32 as 64, d=96 as 160):
    the row count refuses that, and tail_d takes the rows whole, giving the
    JAX engine's intervals through one tail round on the locate rows."""
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, size=2000, dtype=np.uint8)
    sa = suffix_array(codes, method="doubling")
    index = build_index(codes, IndexConfig(k=2, d=64), sa=sa)
    loc = build_locate(codes, sample_rate=8, d=loc_d, sa=sa)
    loc_tables, _, _ = build_locate_tables(loc, lambda a: a)
    state = dict(
        XLAEngine(index).tables,
        tail_entries=loc_tables["locate_rows"],
        **{f"tail_{name}": loc_tables[name] for name in ("dollar_pos", "dollar_base", "dollar_block")},
    )
    with pytest.raises(ValueError, match="k=1"):
        tables_from_jax(state)
    t = tables_from_jax(state, tail_d=loc_d)
    assert (t.d, t.tail_d) == (64, loc_d)
    np.testing.assert_array_equal(t.tail_entries, np.asarray(loc_tables["locate_rows"]))
    queries = _queries(rng, codes, 25)  # 25 % 2: one k=1 tail round
    want, _ = SearchLocateEngine(index, loc, max_hits=4).search_locate(queries)
    np.testing.assert_array_equal(SearchEngine(t, "cpu").search(queries), want)


def test_tables_from_jax_checks_the_padding(rng):
    _, index = _mk(rng, 2, 64)
    tables = dict(XLAEngine(index, pad_words=128).tables)
    with pytest.raises(ValueError, match="cannot hold"):
        tables_from_jax(tables, d=960)  # 2k*30 + 16 = 136 words
    entries = np.asarray(tables["entries"]).copy()
    entries[3, 100] = 1
    tables["entries"] = entries
    with pytest.raises(ValueError, match="non-zero words"):
        tables_from_jax(tables, d=64)


@pytest.mark.parametrize("k,m", [(1, 3), (2, 4), (3, 6)])
def test_prefix_lut_equals_jax(rng, k, m):
    _, index = _mk(rng, k, _D[k])
    engine = SearchEngine(index, "cpu", lut_m=m)
    assert engine.lut_build_seconds is not None
    np.testing.assert_array_equal(
        engine.lut.numpy().view(np.uint32), np.asarray(XLAEngine(index, lut_m=m).tables["lut"])
    )


def _no_build(*args, **kwargs):
    raise AssertionError("the LUT was rebuilt instead of loaded from the cache")


def test_lut_cache_from_jax_loads_in_port(rng, tmp_path, monkeypatch):
    codes, index = _mk(rng, 2, 64)
    cache = str(tmp_path / "ref.fmi.lut4.npz")
    jax_engine = XLAEngine(index, lut_m=4, lut_cache=cache)
    assert os.path.exists(cache)
    monkeypatch.setattr(SearchEngine, "build_prefix_lut", _no_build)
    engine = SearchEngine(index, "cpu", lut_m=4, lut_cache=cache)
    assert engine.lut_build_seconds is None
    queries = _queries(rng, codes, 24)
    np.testing.assert_array_equal(engine.search(queries), jax_engine.search(queries))


def test_lut_cache_from_port_loads_in_jax(rng, tmp_path, monkeypatch):
    codes, index = _mk(rng, 3, 64)
    cache = str(tmp_path / "ref.fmi.lut6")  # no suffix: .npz is appended
    engine = SearchEngine(index, "cpu", lut_m=6, lut_cache=cache)
    assert os.path.exists(cache + ".npz")
    monkeypatch.setattr(xla, "build_prefix_lut", _no_build)
    jax_engine = XLAEngine(index, lut_m=6, lut_cache=cache)
    queries = _queries(rng, codes, 24)
    np.testing.assert_array_equal(engine.search(queries), jax_engine.search(queries))


def test_stale_lut_cache_is_rebuilt(rng, tmp_path, monkeypatch):
    _, other = _mk(rng, 2, 64)
    codes, index = _mk(rng, 2, 64)
    cache = str(tmp_path / "lut.npz")
    SearchEngine(other, "cpu", lut_m=4, lut_cache=cache)
    engine = SearchEngine(index, "cpu", lut_m=4, lut_cache=cache)
    assert engine.lut_build_seconds is not None  # fingerprint differs
    queries = _queries(rng, codes, 24)
    np.testing.assert_array_equal(engine.search(queries), search_oracle(index, queries))
    # and the cache ceiling is honoured
    monkeypatch.setattr(tables_mod, "LUT_CACHE_MAX_BYTES", 0)
    SearchEngine(index, "cpu", lut_m=4, lut_cache=str(tmp_path / "big.npz"))
    assert not os.path.exists(tmp_path / "big.npz")
