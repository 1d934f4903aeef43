"""Hamming distance <= 1 in the port against tpufm: the variant fan-out
(``variants1`` against ``_variants1``), ``SearchEngine.count`` against
``XLAEngine.count`` and ``SearchLocateEngine.locate_mismatch`` against its
JAX twin, each also against a naive sliding-window Hamming scan of the text
(the cases of tests/test_mismatch.py). Counts and positions are integers and
compare exactly (tolerance 0); positions in tpufm's (variant, row) order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufm.config import IndexConfig as JaxIndexConfig
from tpufm.engine import xla
from tpufm.index.builder import build_index as jax_build_index
from tpufm.index.locate import build_locate as jax_build_locate
from tpufm.index.suffix_array import suffix_array
from tpufm_torch import SearchEngine
from tpufm_torch.engine.mismatch import variants1
from tpufm_torch.engine.search_locate import SearchLocateEngine
from tpufm_torch.host.index import IndexConfig, build_index
from tpufm_torch.host.locate import build_locate


def _windows(codes, L):
    return np.lib.stride_tricks.sliding_window_view(codes, L)


def naive_mm_count(codes, read, dist=1) -> int:
    return int(((_windows(codes, read.shape[0]) != read[None, :]).sum(axis=1) <= dist).sum())


def _setup(k=2, d=64, n=1500, seed=31):
    codes = np.random.default_rng(seed).integers(0, 4, size=n, dtype=np.uint8)
    sa = suffix_array(codes, method="doubling")
    return (codes, sa, jax_build_index(codes, JaxIndexConfig(k=k, d=d), sa=sa),
            build_index(codes, IndexConfig(k=k, d=d), sa=sa))


def _reads(codes, L, n, seed, random_tail=0):
    rng = np.random.default_rng(seed)
    qs = np.stack([codes[s : s + L] for s in rng.integers(0, len(codes) - L, size=n)])
    return np.concatenate([qs, rng.integers(0, 4, size=(random_tail, L), dtype=np.uint8)])


@pytest.mark.parametrize("L", [1, 5, 12])
def test_variants1_matches_jax(L):
    qs = np.random.default_rng(L).integers(0, 4, size=(6, L), dtype=np.uint8)
    got = variants1(torch.from_numpy(qs)).numpy()
    np.testing.assert_array_equal(got, np.asarray(xla._variants1(jnp.asarray(qs))))
    assert got.shape == (6, 3 * L + 1, L)
    # every variant is the read with at most one base changed, and all differ
    assert ((got != qs[:, None, :]).sum(axis=2) <= 1).all()
    assert len({v.tobytes() for v in got[0]}) == 3 * L + 1


@pytest.mark.parametrize("qlen,k,lut", [(8, 2, 0), (12, 2, 4), (12, 3, 6)])
def test_count_matches_xla_and_naive(qlen, k, lut):
    codes, _, jidx, idx = _setup(k=k)
    qs = _reads(codes, qlen, 24, seed=qlen + k, random_tail=8)
    ours, theirs = SearchEngine(idx, "cpu", lut_m=lut), xla.XLAEngine(jidx, lut_m=lut)
    got = ours.count(qs, mismatches=1)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, theirs.count(qs, mismatches=1))
    np.testing.assert_array_equal(got, [naive_mm_count(codes, q) for q in qs])
    exact = ours.count(qs)
    np.testing.assert_array_equal(exact, theirs.count(qs))
    np.testing.assert_array_equal(exact, [naive_mm_count(codes, q, 0) for q in qs])
    assert (got >= exact).all() and (exact[:24] >= 1).all()


def test_count_with_tail():
    # 11 % 3 == 2: two k=1 tail rounds for every variant
    codes, sa, jidx, idx = _setup(k=3)
    jtail = jax_build_index(codes, JaxIndexConfig(k=1, d=64), sa=sa)
    tail = build_index(codes, IndexConfig(k=1, d=64), sa=sa)
    qs = _reads(codes, 11, 16, seed=5)
    got = SearchEngine(idx, "cpu", tail_index=tail).count(qs, mismatches=1)
    np.testing.assert_array_equal(got, xla.XLAEngine(jidx, tail_index=jtail).count(qs, mismatches=1))
    np.testing.assert_array_equal(got, [naive_mm_count(codes, q) for q in qs])


def test_count_waves():
    codes, _, jidx, idx = _setup()
    qs = np.random.default_rng(7).integers(0, 4, size=(64, 8), dtype=np.uint8)
    engine = SearchEngine(idx, "cpu")
    got = engine.count(qs, mismatches=1, wave=7)
    np.testing.assert_array_equal(got, engine.count(qs, mismatches=1))
    np.testing.assert_array_equal(got, xla.XLAEngine(jidx).count(qs, mismatches=1, wave=7))
    np.testing.assert_array_equal(engine.count(qs, wave=7), xla.XLAEngine(jidx).count(qs, wave=7))


def test_count_refuses_two_mismatches():
    _, _, jidx, idx = _setup()
    qs = np.zeros((4, 8), np.uint8)
    with pytest.raises(NotImplementedError, match="mismatches=2") as ours:
        SearchEngine(idx, "cpu").count(qs, mismatches=2)
    with pytest.raises(NotImplementedError) as theirs:
        xla.XLAEngine(jidx).count(qs, mismatches=2)
    assert str(ours.value) == str(theirs.value)


def _locate_pair(max_hits, n=1500, seed=41):
    codes = np.random.default_rng(seed).integers(0, 4, size=n, dtype=np.uint8)
    sa = suffix_array(codes, method="doubling")
    jax_engine = xla.SearchLocateEngine(
        jax_build_index(codes, JaxIndexConfig(k=2, d=64), sa=sa),
        jax_build_locate(codes, sample_rate=8, d=64, sa=sa), max_hits=max_hits,
    )
    ours = SearchLocateEngine(build_index(codes, IndexConfig(k=2, d=64), sa=sa),
                              build_locate(codes, sample_rate=8, d=64, sa=sa), "cpu", max_hits=max_hits)
    return codes, ours, jax_engine


def test_locate_mismatch_matches_jax_and_naive():
    """max_hits large enough that nothing is cut: the position set is the
    naive scan's, and the array (order included) is JAX's."""
    codes, ours, theirs = _locate_pair(64)
    qs = _reads(codes, 9, 16, seed=8)
    pos = ours.locate_mismatch(qs)
    np.testing.assert_array_equal(pos, theirs.locate_mismatch(qs))
    wins = _windows(codes, 9)
    for q, row in zip(qs, pos):
        want = set(np.flatnonzero((wins != q[None]).sum(1) <= 1).tolist())
        assert len(want) <= 64, "test setup: raise max_hits"
        assert {int(x) for x in row if x != 0xFFFFFFFF} == want


def test_locate_mismatch_cap_and_waves():
    codes, ours, theirs = _locate_pair(2, n=1200)
    qs = np.random.default_rng(9).integers(0, 4, size=(24, 6), dtype=np.uint8)  # many hits
    pos = ours.locate_mismatch(qs)
    assert pos.shape == (24, 2) and pos.dtype == np.uint32
    np.testing.assert_array_equal(pos, theirs.locate_mismatch(qs))
    np.testing.assert_array_equal(ours.locate_mismatch(qs, wave=5), pos)
    np.testing.assert_array_equal(theirs.locate_mismatch(qs, wave=5), pos)
    wins = _windows(codes, 6)
    want_n = [min(2, naive_mm_count(codes, q)) for q in qs]
    np.testing.assert_array_equal((pos != 0xFFFFFFFF).sum(1), want_n)
    for q, row in zip(qs, pos):
        for x in row[row != 0xFFFFFFFF]:
            assert (wins[int(x)] != q).sum() <= 1


def test_locate_mismatch_empty_batch():
    _, ours, _ = _locate_pair(4, n=500)
    pos = ours.locate_mismatch(np.zeros((0, 9), np.uint8))
    assert pos.shape == (0, 4) and pos.dtype == np.uint32
