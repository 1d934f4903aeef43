"""The port's locate against tpufm's: the host tables and numpy oracle
(tpufm_torch.host.locate), the walk (``locate_walk_reference``, the plain
version of K4) through ``LocateEngine``, and the fused ``SearchLocateEngine``,
each on the same seeded inputs as tpufm's ``build_locate``,
``locate_oracle``, ``LocateEngine`` and ``SearchLocateEngine`` (the cases of
tests/test_locate.py). Positions and intervals are integers and compare
exactly (tolerance 0), in tpufm's order (BWT row order, not sorted)."""

import jax
import numpy as np
import pytest
import torch

from tpufm.config import IndexConfig as JaxIndexConfig
from tpufm.engine import xla
from tpufm.index import locate as jloc
from tpufm.index.builder import build_index as jax_build_index
from tpufm.index.suffix_array import suffix_array
from tpufm_torch import SearchEngine, tables_from_jax
from tpufm_torch.engine import locate as loc_mod
from tpufm_torch.engine.locate import (
    LocateEngine,
    LocateTables,
    locate_tables_from_index,
    locate_tables_from_jax,
    locate_walk,
    locate_walk_reference,
)
from tpufm_torch.engine.search_locate import SearchLocateEngine
from tpufm_torch.host import locate as host_loc
from tpufm_torch.host.index import IndexConfig, build_index
from tpufm_torch.host.oracle import search_oracle

_LOC_ARRAYS = ("mark_words", "mark_rank", "samples")


def naive_positions(text: np.ndarray, pattern: np.ndarray) -> list:
    wins = np.lib.stride_tricks.sliding_window_view(text, pattern.shape[0])
    return np.flatnonzero((wins == pattern).all(axis=1)).tolist()


def _text(n, seed=21):
    codes = np.random.default_rng(seed).integers(0, 4, size=n, dtype=np.uint8)
    return codes, suffix_array(codes, method="doubling")


def _both(codes, sa, k, d, s, loc_d=None):
    """(tpufm index, tpufm locate, port index, port locate) from one SA."""
    loc_d = loc_d or d
    return (
        jax_build_index(codes, JaxIndexConfig(k=k, d=d), sa=sa),
        jloc.build_locate(codes, sample_rate=s, d=loc_d, sa=sa),
        build_index(codes, IndexConfig(k=k, d=d), sa=sa),
        host_loc.build_locate(codes, sample_rate=s, d=loc_d, sa=sa),
    )


def _reads(codes, L, n, seed):
    starts = np.random.default_rng(seed).integers(0, len(codes) - L, size=n)
    return np.stack([codes[s : s + L] for s in starts])


# (s, d, n): n = 6*64 - 1 makes bwtsize % d == 0
_CASES = [(4, 32, 1200), (32, 64, 1200), (7, 32, 1200), (8, 64, 6 * 64 - 1)]


@pytest.mark.parametrize("s,d,n", _CASES)
def test_build_locate_matches_tpufm(s, d, n):
    codes, sa = _text(n)
    ours = host_loc.build_locate(codes, sample_rate=s, d=d, sa=sa)
    theirs = jloc.build_locate(codes, sample_rate=s, d=d, sa=sa)
    assert ours.sample_rate == theirs.sample_rate
    for name in _LOC_ARRAYS:
        a, b = getattr(ours, name), getattr(theirs, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("occ", "bitmaps", "dollar_pos", "dollar_base"):
        np.testing.assert_array_equal(getattr(ours.lf1, name), getattr(theirs.lf1, name), err_msg=name)
    # the locate rows equal the JAX engine's device table
    jt, jd, js = xla.build_locate_tables(theirs, lambda a: a)
    t = locate_tables_from_index(ours)
    assert (t.d, t.sample_rate, t.bwtsize) == (jd, js, n + 1)
    np.testing.assert_array_equal(t.rows, jt["locate_rows"])
    np.testing.assert_array_equal(t.samples, jt["samples"])


def test_build_locate_takes_text_and_its_own_sort():
    codes, sa = _text(400)
    text = bytes(b"ACGT"[c] for c in codes)
    ours = host_loc.build_locate(text, sample_rate=8, d=32, sa_method="doubling")
    np.testing.assert_array_equal(ours.samples, host_loc.build_locate(codes, 8, 32, sa=sa).samples)
    native = host_loc.build_locate(codes, sample_rate=8, d=32)  # SA-IS
    np.testing.assert_array_equal(native.mark_words, ours.mark_words)


@pytest.mark.parametrize("s,d,n", _CASES)
def test_locate_oracle_resolves_every_row(s, d, n):
    codes, sa = _text(n)
    loc = host_loc.build_locate(codes, sample_rate=s, d=d, sa=sa)
    rows = np.arange(n + 1, dtype=np.uint32)
    got = host_loc.locate_oracle(loc, rows)
    np.testing.assert_array_equal(got, sa.astype(np.uint32))
    np.testing.assert_array_equal(got, jloc.locate_oracle(jloc.build_locate(codes, s, d, sa=sa), rows))


@pytest.mark.parametrize("s,d,n", _CASES)
def test_walk_every_row_matches_sa_and_jax(s, d, n):
    """The plain walk through LocateEngine over every BWT row equals the SA
    and JAX's LocateEngine.locate_rows, also for rows at and past bwtsize
    (clamped rows, which JAX gathers clamped too), and in waves."""
    codes, sa = _text(n)
    ours = LocateEngine(host_loc.build_locate(codes, sample_rate=s, d=d, sa=sa), "cpu")
    theirs = xla.LocateEngine(jloc.build_locate(codes, sample_rate=s, d=d, sa=sa))
    rows = np.arange(n + 1, dtype=np.uint32)
    got = ours.locate_rows(rows)
    np.testing.assert_array_equal(got, sa.astype(np.uint32))
    past = np.asarray([n + 1, n + 1 + d // 2, (n // d + 3) * d + 5], dtype=np.uint32)
    np.testing.assert_array_equal(ours.locate_rows(past), theirs.locate_rows(past))
    shuffled = np.random.default_rng(s).permutation(np.concatenate([rows, past]))
    np.testing.assert_array_equal(ours.locate_rows(shuffled, wave=128), theirs.locate_rows(shuffled, wave=128))


def test_walk_trip_count_and_freeze():
    """Exactly sample_rate iterations, the mark tested before the hop: with
    too few iterations a lane stays 0xFFFFFFFF, as in JAX's walk."""
    codes, sa = _text(600)
    loc = host_loc.build_locate(codes, sample_rate=8, d=32, sa=sa)
    t = locate_tables_from_index(loc)
    args = [torch.from_numpy(a) for a in (t.rows.view(np.int32), t.samples.view(np.int32),
                                          t.dollar.astype(np.int64))]
    p = torch.arange(601, dtype=torch.int64)
    short = locate_walk(*args, p, 32, 3).numpy()
    want = np.where(sa % 8 <= 2, sa, 0xFFFFFFFF)  # reached within 2 hops
    np.testing.assert_array_equal(short, want)
    jt, _, _ = xla.build_locate_tables(jloc.build_locate(codes, 8, 32, sa=sa), lambda a: a)
    np.testing.assert_array_equal(short, np.asarray(jax.jit(xla.make_locate_fn(32, 3))(jt, p.numpy().astype(np.uint32))))


def test_locate_hits_match_jax_oracle_and_naive():
    codes, sa = _text(3000)
    jidx, jl, idx, loc = _both(codes, sa, 2, 64, 16)
    queries = _reads(codes, 6, 24, seed=2)
    iv = search_oracle(idx, queries)
    ours = LocateEngine(loc, "cpu").locate_hits(iv, max_hits=32)
    np.testing.assert_array_equal(ours, xla.LocateEngine(jl).locate_hits(iv, max_hits=32))
    np.testing.assert_array_equal(ours, host_loc.locate_hits(loc, iv, 32))
    np.testing.assert_array_equal(ours, jloc.locate_hits(jl, iv, 32))
    for q, row in zip(queries, ours):
        assert sorted(int(x) for x in row if x != 0xFFFFFFFF) == naive_positions(codes, q)[:32]


def test_search_locate_matches_jax_and_two_pass():
    """Fused equals JAX's fused and the port's own two-pass, including an
    absent read and a wave that does not divide the batch."""
    codes, sa = _text(6000)
    jidx, jl, idx, loc = _both(codes, sa, 2, 64, 16)
    queries = _reads(codes, 8, 37, seed=3)
    queries[-1] = [0, 1, 2, 3] * 2  # likely absent
    iv, pos = SearchLocateEngine(idx, loc, "cpu", max_hits=8).search_locate(queries, wave=16)
    jiv, jpos = xla.SearchLocateEngine(jidx, jl, max_hits=8).search_locate(queries, wave=16)
    np.testing.assert_array_equal(iv, jiv)
    np.testing.assert_array_equal(pos, jpos)
    two = SearchEngine(idx, "cpu").search(queries)
    np.testing.assert_array_equal(iv, two)
    np.testing.assert_array_equal(pos, LocateEngine(loc, "cpu").locate_hits(two, max_hits=8))


def test_search_locate_with_lut():
    codes, sa = _text(6000)
    jidx, jl, idx, loc = _both(codes, sa, 2, 64, 16)
    queries = _reads(codes, 12, 16, seed=4)
    engine = SearchLocateEngine(idx, loc, "cpu", max_hits=4, lut_m=4)
    assert engine.search_engine.lut_m == 4
    iv, pos = engine.search_locate(queries)
    jiv, jpos = xla.SearchLocateEngine(jidx, jl, max_hits=4, lut_m=4).search_locate(queries)
    np.testing.assert_array_equal(iv, jiv)
    np.testing.assert_array_equal(pos, jpos)


def test_search_locate_empty_batch():
    codes, sa = _text(2000)
    _, _, idx, loc = _both(codes, sa, 2, 64, 16)
    iv, pos = SearchLocateEngine(idx, loc, "cpu", max_hits=4).search_locate(np.zeros((0, 8), np.uint8))
    assert iv.shape == (0, 2) and pos.shape == (0, 4)
    assert iv.dtype == pos.dtype == np.uint32


@pytest.mark.parametrize("max_hits,s", [(1, 1), (64, 4)])
def test_search_locate_edges(max_hits, s):
    """max_hits=1 truncates, 64 is far past every width, and s=1 marks
    every row (the walk stops before its first hop)."""
    codes, sa = _text(3000)
    jidx, jl, idx, loc = _both(codes, sa, 1, 32, s)
    queries = _reads(codes, 4, 21, seed=5)  # short: wide intervals
    iv, pos = SearchLocateEngine(idx, loc, "cpu", max_hits=max_hits).search_locate(queries)
    jiv, jpos = xla.SearchLocateEngine(jidx, jl, max_hits=max_hits).search_locate(queries)
    np.testing.assert_array_equal(iv, jiv)
    np.testing.assert_array_equal(pos, jpos)


@pytest.mark.parametrize("k,d,loc_d,L,lut_m", [(2, 64, 64, 9, 0), (3, 64, 32, 25, 6), (3, 192, 96, 31, 0)])
def test_search_locate_tail_on_the_locate_rows(k, d, loc_d, L, lut_m):
    """L - lut_m not a multiple of k: the leftover characters take k=1
    rounds on the locate rows themselves, at the locate tables' own d."""
    codes, sa = _text(3000)
    jidx, jl, idx, loc = _both(codes, sa, k, d, 8, loc_d=loc_d)
    queries = _reads(codes, L, 30, seed=L)
    engine = SearchLocateEngine(idx, loc, "cpu", max_hits=5, lut_m=lut_m)
    assert engine.search_engine.tail_d == loc_d
    iv, pos = engine.search_locate(queries)
    jiv, jpos = xla.SearchLocateEngine(jidx, jl, max_hits=5, lut_m=lut_m).search_locate(queries)
    np.testing.assert_array_equal(iv, jiv)
    np.testing.assert_array_equal(pos, jpos)
    np.testing.assert_array_equal(iv, search_oracle(idx, queries, tail_index=loc.lf1))
    assert (pos[:, 0] != 0xFFFFFFFF).all()


def test_locate_tables_from_jax_drive_the_port_to_jax_outputs():
    codes, sa = _text(3000)
    jidx, jl, _, _ = _both(codes, sa, 2, 64, 8, loc_d=32)
    jax_engine = xla.SearchLocateEngine(jidx, jl, max_hits=6, lut_m=4)
    tables = tables_from_jax(jax_engine.tables)
    loc_tables = locate_tables_from_jax(jax_engine.loc_tables, d=32, sample_rate=8)
    assert isinstance(loc_tables, LocateTables) and loc_tables.bwtsize == 3001
    engine = SearchLocateEngine(tables, loc_tables, "cpu", max_hits=6)
    assert engine.search_engine.lut_m == 4
    queries = _reads(codes, 13, 40, seed=6)  # 13 - 4 odd: one tail round
    for ours, theirs in zip(engine.search_locate(queries), jax_engine.search_locate(queries)):
        np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(engine.locate_mismatch(queries[:, :9]),
                                  jax_engine.locate_mismatch(queries[:, :9]))
    rows = np.arange(3001, dtype=np.uint32)
    np.testing.assert_array_equal(LocateEngine(loc_tables, "cpu").locate_rows(rows),
                                  xla.LocateEngine(jl).locate_rows(rows))


def test_locate_tables_from_jax_checks_its_input():
    codes, sa = _text(1000)
    jl = jloc.build_locate(codes, sample_rate=8, d=64, sa=sa)
    jt, _, _ = xla.build_locate_tables(jl, lambda a: a)
    with pytest.raises(ValueError, match="are not"):
        locate_tables_from_jax(jt, d=32, sample_rate=8)  # rows of d=64
    with pytest.raises(ValueError, match="multiple of 32"):
        locate_tables_from_jax(jt, d=48, sample_rate=8)
    cut = dict(jt, locate_rows=np.asarray(jt["locate_rows"])[1:])
    with pytest.raises(ValueError, match="row count"):
        locate_tables_from_jax(cut, d=64, sample_rate=8)


def test_locate_refuses_a_non_k1_table_and_another_text():
    codes, sa = _text(300)
    k2 = build_index(codes, IndexConfig(k=2, d=32), sa=sa)
    bogus = host_loc.LocateIndex(lf1=k2, sample_rate=8, mark_words=np.zeros((1, 1), np.uint32),
                                 mark_rank=np.zeros(1, np.uint32), samples=np.zeros(1, np.uint32))
    with pytest.raises(ValueError, match="k=1"):
        LocateEngine(bogus, "cpu")
    other, osa = _text(301, seed=3)
    with pytest.raises(ValueError, match="different texts"):
        SearchLocateEngine(k2, host_loc.build_locate(other, 8, 32, sa=osa), "cpu")


def test_locate_walk_argument_errors():
    codes, sa = _text(300)
    t = locate_tables_from_index(host_loc.build_locate(codes, sample_rate=8, d=32, sa=sa))
    rows, samples = torch.from_numpy(t.rows.view(np.int32)), torch.from_numpy(t.samples.view(np.int32))
    dollar, p = torch.from_numpy(t.dollar.astype(np.int64)), torch.arange(10)
    before = loc_mod.LAUNCHES
    for bad, match in [
        ((rows, samples, dollar, p, 48, 8), "multiple of 32"),
        ((rows, samples, dollar, p, 32, 0), "sample_rate"),
        ((rows[:, :7], samples, dollar, p, 32, 8), "words >= 8"),
        ((rows, samples.long(), dollar, p, 32, 8), "samples"),
        ((rows, samples, dollar.view(1, 3), p, 32, 8), "dollar"),
        ((rows, samples, dollar, p.int(), 32, 8), "int64"),
    ]:
        with pytest.raises(ValueError, match=match):
            locate_walk(*bad)
    # the plain version on the CPU, never counted as a launch
    np.testing.assert_array_equal(locate_walk(rows, samples, dollar, p, 32, 8).numpy(), sa[:10])
    np.testing.assert_array_equal(locate_walk_reference(rows, samples, dollar, p, 32, 8).numpy(), sa[:10])
    assert loc_mod.LAUNCHES == before
