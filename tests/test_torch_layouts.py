"""The engine's layouts on the CPU against tpufm's: the plain rounds of the
split, alternate-counters and paired tables against ``lf_step_split``,
``lf_step_ac`` (and the numpy ``lf_step_oracle_ac``) and
``lf_step_paired`` on the same tables (carried across by
``tables_from_jax``), on edge intervals (0, bwtsize, the block edges, the
'$' positions and their neighbours); ``SearchEngine(layout="split" |
"paired", pad_words=...)`` against ``XLAEngine`` with and without LUT and
tail, the paired layout's ``last_repair_fraction`` on a repeat-rich text;
and every refusal, with XLAEngine's type and text. Inputs are made with
numpy from a seed; intervals are integers and compare exactly (tolerance
0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufm.config import IndexConfig as JaxIndexConfig
from tpufm.engine.oracle import lf_step_oracle_ac, search_oracle
from tpufm.engine.xla import XLAEngine, lf_step_ac, lf_step_paired, lf_step_split
from tpufm.index.builder import build_index as jax_build_index
from tpufm.index.builder import derive_tail as jax_derive_tail
from tpufm.index.layouts import make_alt_counters as jax_make_alt_counters
from tpufm_torch import SearchEngine, tables_from_jax
from tpufm_torch.engine import lf_round as lf_mod
from tpufm_torch.engine.tables import build_paired_entries, tables_from_index
from tpufm_torch.host.index import IndexConfig, KStepFMIndex, build_index


def _text(k, d, n, seed=5, repeat=False):
    codes = np.random.default_rng(seed + n).integers(0, 4, size=n, dtype=np.uint8)
    if repeat:  # a period-4 repeat: intervals of hundreds of rows, wider than two blocks
        codes[n // 4: 3 * n // 4] = np.tile(np.arange(4, dtype=np.uint8), n // 8)
    return codes, jax_build_index(codes, JaxIndexConfig(k=k, d=d), sa_method="doubling")


def _edges(index, n=400, seed=3):
    """uint32 [*, 2] reads (lo <= hi) and uint32 codes: every edge end (0,
    bwtsize, each multiple of d and its neighbours, each '$' position and
    its neighbours) with itself, the next end, the end a block on and a
    random end past it; then n random reads."""
    rng = np.random.default_rng(seed)
    bwtsize, d, k = index.bwtsize, index.config.d, index.config.k
    ends = [0, bwtsize] + [m + o for m in range(0, bwtsize + 1, d) for o in (-1, 0, 1)]
    ends += [int(p) + o for p in index.dollar_pos for o in (-1, 0, 1)]
    ends = np.unique(np.clip(ends, 0, bwtsize))
    his = [ends, np.minimum(ends + 1, bwtsize), np.minimum(ends + d, bwtsize), rng.integers(ends, bwtsize + 1)]
    lo = rng.integers(0, bwtsize + 1, size=n)
    his_r = np.minimum(lo + rng.integers(0, 3 * d, size=n), bwtsize)
    iv = np.concatenate([np.stack([ends, h], axis=1) for h in his] + [np.stack([lo, his_r], axis=1)])
    return iv.astype(np.uint32), rng.integers(0, 4**k, size=iv.shape[0]).astype(np.uint32)


def _t(a, dtype=torch.int64):
    a = np.array(a)  # a writable copy
    return torch.from_numpy(a.view(np.int32) if dtype == torch.int32 else a.astype(np.int64))


#: (k, d, n): k 1-4 at d 64 and 128, texts of a partial last block and of
#: whole blocks (n + 1 a multiple of d: bwtsize reads the sentinel row)
KDN = [(1, 64, 1500), (1, 128, 128 * 12 - 1), (2, 64, 64 * 30 - 1), (2, 128, 2500),
       (3, 64, 2200), (3, 128, 128 * 18 - 1), (4, 64, 2000), (4, 128, 128 * 16 - 1)]


@pytest.mark.parametrize("k,d,n", KDN)
def test_split_round_equals_lf_step_split(k, d, n):
    _, index = _text(k, d, n)
    jt = XLAEngine(index, layout="split").tables
    t = tables_from_jax(jt)
    assert t.layout == "split" and t.bwtsize == index.bwtsize and t.d == d
    iv, code = _edges(index)
    want = np.asarray(lf_step_split(jt, (k, d, d // 32), jnp.asarray(iv), jnp.asarray(code)))
    got = lf_mod.lf_round_split(_t(t.bitmaps, torch.int32), _t(t.occ, torch.int32), _t(iv), _t(code),
                                _t(t.dollar), k, d)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("k,d,n", KDN)
def test_ac_round_equals_lf_step_ac_and_oracle(k, d, n):
    _, index = _text(k, d, n)
    ac = jax_make_alt_counters(index)
    jt = XLAEngine(ac).tables
    t = tables_from_jax(jt)
    assert t.layout == "alt_counters" and t.bwtsize == index.bwtsize
    iv, code = _edges(index)
    cfg = (k, d, d // 32, 4**k // 2)
    want = np.stack([np.asarray(lf_step_ac(jt, cfg, jnp.asarray(iv[:, j]), jnp.asarray(code))) for j in (0, 1)], 1)
    oracle = np.stack([lf_step_oracle_ac(ac, iv[:, j], code) for j in (0, 1)], 1)
    np.testing.assert_array_equal(want, oracle)
    got = lf_mod.lf_round_ac(_t(t.bitmaps, torch.int32), _t(t.occ_slim, torch.int32), _t(iv), _t(code),
                             _t(t.dollar), k, d)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("k,d,n", KDN)
def test_paired_round_equals_lf_step_paired(k, d, n):
    """Every read, ok or not (the same formula; a read whose ends lie more
    than a block apart takes hi on the first half, as in tpufm)."""
    _, index = _text(k, d, n)
    jt = XLAEngine(index, layout="paired", lut_m=k).tables
    t = tables_from_jax(jt)
    assert t.layout == "paired"
    iv, code = _edges(index)
    want, want_ok = lf_step_paired(jt, (k, d, d // 32), jnp.asarray(iv), jnp.asarray(code))
    got, ok = lf_mod.lf_round_paired(_t(t.entries_paired, torch.int32), _t(iv), _t(code), _t(t.dollar), k, d)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok))
    assert ok.any() and not ok.all()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    # on the engine's device rows (halves of a multiple of 4 words) the same
    rows = SearchEngine(index_port(index), "cpu", layout="paired", lut_m=k).entries_paired
    assert rows.shape[1] % 8 == 0 and torch.equal(rows, build_paired_entries(SearchEngine(
        index_port(index), "cpu").entries))
    np.testing.assert_array_equal(lf_mod.lf_round_paired(rows, _t(iv), _t(code), _t(t.dollar), k, d)[0].numpy(),
                                  got.numpy())


def _paired_case(index, rows: int, pattern: str, n=320, seed=4):
    """uint32 [n, 2] reads and codes whose hi lies, against lo's block b
    (the pair the paired round takes, clamped to the last of ``rows``):
    "same" in b, "next" in b + 1 (hi on the pair's second half), "far" 2-5
    blocks on, "wrapped" in b - 1 (hi < lo, delta 2^32 - 1), "last row" b
    the last pair row or past it, hi in b or b + 1 (the zero half)."""
    rng = np.random.default_rng(seed + len(pattern))
    d, k = index.config.d, index.config.k
    b = rng.integers(1, rows - 6, size=n)
    step = {"same": 0, "next": 1, "far": rng.integers(2, 6, size=n), "wrapped": -1,
            "last row": rng.integers(0, 2, size=n)}[pattern]
    if pattern == "last row":
        b = rows - 1 + np.arange(n) % 2
    iv = np.stack([b * d + rng.integers(0, d, size=n), (b + step) * d + rng.integers(0, d, size=n)], axis=1)
    return iv.astype(np.uint32), rng.integers(0, 4**k, size=n).astype(np.uint32)


@pytest.mark.parametrize("width", ["host", "padded"])
@pytest.mark.parametrize("pattern", ["same", "next", "far", "wrapped", "last row"])
@pytest.mark.parametrize("k,d,n", [(1, 64, 1500), (3, 128, 128 * 18 - 1), (4, 64, 2000)])
def test_paired_round_cases_equal_lf_step_paired(k, d, n, pattern, width):
    """The cases the paired kernel branches on (delta 0, 1, >= 2, wrapped,
    lo in the last pair row or past it), each on every read: the port's
    paired round on tpufm's table (host widths, through ``tables_from_jax``)
    or on the engine's padded device rows, against ``lf_step_paired``."""
    _, index = _text(k, d, n)
    jt = XLAEngine(index, layout="paired", lut_m=k).tables
    t = tables_from_jax(jt)
    rows = (_t(t.entries_paired, torch.int32) if width == "host"
            else SearchEngine(index_port(index), "cpu", layout="paired", lut_m=k).entries_paired)
    iv, code = _paired_case(index, rows.shape[0], pattern)
    want, want_ok = lf_step_paired(jt, (k, d, d // 32), jnp.asarray(iv), jnp.asarray(code))
    delta = (iv[:, 1] // d - iv[:, 0] // d).astype(np.uint32)
    np.testing.assert_array_equal(np.asarray(want_ok), delta <= 1)
    got, ok = lf_mod.lf_round_paired(rows, _t(iv), _t(code), _t(t.dollar), k, d)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def index_port(index):
    """The port's index of the same arrays."""
    cfg = IndexConfig(k=index.config.k, d=index.config.d)
    return KStepFMIndex(cfg, index.bwtsize, index.occ, index.bitmaps, index.dollar_pos, index.dollar_base)


def _reads(codes, L, n=96, seed=9, repeat=False):
    rng = np.random.default_rng(seed + L)
    starts = rng.integers(0, codes.shape[0] - L, size=n)
    if repeat:
        starts[: n // 3] = rng.integers(codes.shape[0] // 4, codes.shape[0] // 2, size=n // 3)
    q = codes[starts[:, None] + np.arange(L)]
    q[::7] = rng.integers(0, 4, size=q[::7].shape, dtype=np.uint8)
    return q


@pytest.mark.parametrize(
    "layout,k,d,L,lut_m,tail",
    [("split", 2, 64, 24, 0, False), ("split", 3, 128, 24, 6, False), ("split", 3, 64, 31, 6, True),
     ("split", 4, 64, 25, 0, True), ("paired", 1, 64, 20, 2, False), ("paired", 3, 64, 24, 6, False),
     ("paired", 2, 128, 25, 4, True), ("paired", 4, 64, 24, 4, False)],
)
def test_layout_search_equals_xla(layout, k, d, L, lut_m, tail):
    codes, index = _text(k, d, 3000, repeat=layout == "paired")
    tail_index = jax_derive_tail(index) if tail else None
    q = _reads(codes, L, repeat=layout == "paired")
    jax_eng = XLAEngine(index, layout=layout, lut_m=lut_m, tail_index=tail_index)
    want = jax_eng.search(q)
    np.testing.assert_array_equal(want, search_oracle(index, q, tail_index=tail_index))
    eng = SearchEngine(index, "cpu", layout=layout, lut_m=lut_m, tail_index=tail_index)
    assert eng.layout == layout and not eng.alt_counters
    np.testing.assert_array_equal(eng.search(q, wave=40), want)
    if lut_m:  # the LUT is the JAX engine's (built with split rounds / fused rounds)
        np.testing.assert_array_equal(eng.lut.numpy().view(np.uint32), np.asarray(jax_eng.tables["lut"]))
    # the same state carried across from the JAX engine
    np.testing.assert_array_equal(SearchEngine(tables_from_jax(jax_eng.tables), "cpu").search(q), want)
    if layout == "paired":
        eng.search(q)  # one wave: the fraction of the whole batch
        assert eng.last_repair_fraction == jax_eng.last_repair_fraction
        assert 0 < eng.last_repair_fraction < 1


@pytest.mark.parametrize("k,L,lut_m", [(2, 24, 0), (3, 25, 6)])
def test_pad_words_search_equals_xla(k, L, lut_m):
    codes, index = _text(k, 64, 2500)
    tail_index = jax_derive_tail(index) if L % k else None
    q = _reads(codes, L)
    jax_eng = XLAEngine(index, pad_words=128, lut_m=lut_m, tail_index=tail_index)
    assert jax_eng.tables["entries"].shape[1] == 128
    eng = SearchEngine(index, "cpu", pad_words=128, lut_m=lut_m, tail_index=tail_index)
    assert tuple(eng.entries.shape) == (index.occ.shape[0], 128)
    np.testing.assert_array_equal(eng.search(q), jax_eng.search(q))
    t = tables_from_index(index, pad_words=128)
    assert t.entries.shape[1] == 128 and not t.entries[:, 2 * k * 2 + 4**k:].any()


def _refusal(jax_call, torch_call):
    with pytest.raises(ValueError) as want:
        jax_call()
    with pytest.raises(ValueError) as got:
        torch_call()
    assert str(got.value) == str(want.value)


def test_layout_refusals_equal_xla():
    codes, index = _text(3, 64, 2000)
    q = _reads(codes, 24)
    tail = jax_derive_tail(index)
    for kw in ({"layout": "paired"}, {"layout": "tiled"}, {"layout": "tiled", "lut_m": 3},
               {"layout": "split", "gather": "dma"}, {"layout": "paired", "lut_m": 4}):
        jkw = {**kw, "gather": "dma"} if "gather" in kw else kw
        _refusal(lambda: XLAEngine(index, **jkw), lambda: SearchEngine(index, "cpu", **kw))
    split = (XLAEngine(index, layout="split"), SearchEngine(index, "cpu", layout="split"))
    paired = (XLAEngine(index, layout="paired", lut_m=3), SearchEngine(index, "cpu", layout="paired", lut_m=3))
    padded = np.full((4, 24), 0xFF, np.uint8)
    padded[:, 4:] = q[:4, 4:]
    for jax_eng, eng in (split, paired):
        _refusal(lambda: jax_eng.search_varlen(padded), lambda: eng.search_varlen(padded))
        _refusal(lambda: jax_eng.count(q, mismatches=1), lambda: eng.count(q, mismatches=1))
    # lengths that leave characters with no tail: the layouts' own texts
    _refusal(lambda: split[0].search(q[:, 1:]), lambda: split[1].search(q[:, 1:]))
    _refusal(lambda: paired[0].search(q[:, 1:]), lambda: paired[1].search(q[:, 1:]))
    # with a tail, the same lengths search
    tailed = SearchEngine(index, "cpu", layout="paired", lut_m=3, tail_index=tail)
    np.testing.assert_array_equal(tailed.search(q[:, 1:]), search_oracle(index, q[:, 1:], tail_index=tail))
    # exact counts ride the layout's search (the paired one repaired)
    np.testing.assert_array_equal(paired[1].count(q), paired[0].count(q))


def test_paired_device_search_returns_ok_mask():
    """search_device and search_device_waved of the paired layout give the
    intervals and the ok mask, as XLAEngine.search_device gives them (the
    intervals of the reads that are not ok are not the search's)."""
    codes, index = _text(2, 64, 3000, repeat=True)
    q = _reads(codes, 24, n=64, repeat=True)
    want_iv, want_ok = XLAEngine(index, layout="paired", lut_m=4).search_device(jnp.asarray(q))
    eng = SearchEngine(index, "cpu", layout="paired", lut_m=4)
    iv, ok = eng.search_device(torch.from_numpy(q))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok))
    assert not ok.all() and ok.any()
    np.testing.assert_array_equal(iv.numpy()[ok.numpy()], np.asarray(want_iv).astype(np.int64)[ok.numpy()])
    w_iv, w_ok = eng.search_device_waved(torch.from_numpy(q), wave=16)
    assert torch.equal(w_iv, iv) and torch.equal(w_ok, ok)
    # the plain rounds (step) give the same
    iv2, ok2 = eng.search_device(torch.from_numpy(q), step=lf_mod.lf_round_reference)
    assert torch.equal(iv2, iv) and torch.equal(ok2, ok)


def test_tables_from_jax_checks_the_paired_table():
    _, index = _text(2, 64, 1500)
    jt = dict(XLAEngine(index, layout="paired", lut_m=2).tables)
    bad = np.asarray(jt["entries_paired"]).copy()
    bad[3, -1] ^= 1
    jt["entries_paired"] = bad
    with pytest.raises(ValueError, match="pairs of the fused rows"):
        tables_from_jax(jt)


def test_split_tables_of_the_port_index_equal_jax():
    codes, index = _text(3, 128, 2000)
    ours = build_index(codes, IndexConfig(k=3, d=128), sa_method="doubling")
    t = tables_from_index(ours, layout="split")
    jt = tables_from_jax(XLAEngine(index, layout="split").tables)
    np.testing.assert_array_equal(t.bitmaps, jt.bitmaps)
    np.testing.assert_array_equal(t.occ, jt.occ)
    assert t.entries is None and t.layout == "split"
