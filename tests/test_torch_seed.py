"""Seed-and-extend (Hamming distance m >= 1) in the port against tpufm: the
text and read packing, the Hamming verify's plain version against
``hamming_to_text``, and ``SeedExtendEngine`` on the CPU against tpufm's
engine (with its walk and verify budgets set and disabled: its results do
not depend on them) and against the naive sliding-window oracle, on tpufm's
own fixtures (3,000-base texts, k in {1, 2, 3}, lut in {0, 6}). Positions,
counts, flags and distances are integers and compare exactly (tolerance 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufm.config import IndexConfig as JaxIndexConfig
from tpufm.engine import seed as jax_seed
from tpufm.index.builder import build_index as jax_build_index
from tpufm.index.locate import build_locate as jax_build_locate
from tpufm.index.suffix_array import suffix_array
from tpufm_torch.engine import seed
from tpufm_torch.host.index import IndexConfig, build_index
from tpufm_torch.host.locate import build_locate

SENT = 0xFFFFFFFF


def _setup(k=3, d=64, n=3000, s=8, seed_=1234, codes=None):
    """(codes, tpufm index, tpufm locate tables, port index, port locate
    tables) from one suffix sort."""
    if codes is None:
        codes = np.random.default_rng(seed_).integers(0, 4, size=n, dtype=np.uint8)
    sa = suffix_array(codes, method="doubling")
    return (codes, jax_build_index(codes, JaxIndexConfig(k=k, d=d), sa=sa),
            jax_build_locate(codes, sample_rate=s, d=d, sa=sa),
            build_index(codes, IndexConfig(k=k, d=d), sa=sa), build_locate(codes, sample_rate=s, d=d, sa=sa))


def _planted(codes, L, m, seed_, n_sampled=24, n_random=8):
    """Text windows with up to m substitutions each, then random reads
    (tests/test_seed.py's ``_reads_with_planted``)."""
    rng = np.random.default_rng(seed_)
    starts = rng.integers(0, len(codes) - L + 1, size=n_sampled)
    qs = np.stack([codes[s : s + L].copy() for s in starts])
    for i in range(n_sampled):
        for p in rng.choice(L, size=rng.integers(0, m + 1), replace=False):
            qs[i, p] = (qs[i, p] + rng.integers(1, 4)) & 3
    return np.concatenate([qs, rng.integers(0, 4, size=(n_random, L), dtype=np.uint8)])


def _equal(got, want):
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [1, 15, 16, 17, 53, 3000])
def test_pack_text_words_byte_equal(n):
    codes = np.random.default_rng(n).integers(0, 4, size=n, dtype=np.uint8)
    got = seed.pack_text_words(codes)
    want = jax_seed.pack_text_words(codes)
    assert got.dtype == np.uint32 and got.tobytes() == want.tobytes()
    assert got[-1] == 0  # the guard word


@pytest.mark.parametrize("L", [1, 16, 21, 30, 120, 151])
def test_pack_query_words_and_mask_equal(L):
    qs = np.random.default_rng(L).integers(0, 4, size=(5, L), dtype=np.uint8)
    got = seed.pack_query_words(torch.from_numpy(qs)).numpy()
    want = np.asarray(jax_seed.pack_query_words(jnp.asarray(qs)))
    assert got.astype(np.uint32).tobytes() == want.tobytes() and (got >= 0).all()
    assert seed._window_mask(L).tobytes() == jax_seed._window_mask(L).tobytes()


@pytest.mark.parametrize("L", [1, 15, 16, 17, 37, 120, 151])
def test_hamming_reference_equals_tpufm(L):
    """Starts at every 16-base offset, the last valid start n - L and starts
    past it, whose words clamp to the last one as JAX's gather clamps;
    invalid lanes read L + 1."""
    rng = np.random.default_rng(L)
    n = 400
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    words = seed.pack_text_words(codes)
    pos = rng.integers(0, n - L + 1, size=96).astype(np.uint32)
    pos[:16] = 64 + np.arange(16)
    pos[16], pos[17], pos[18] = n - L, n, n + 40
    qs = rng.integers(0, 4, size=(96, L), dtype=np.uint8)
    qs[::3] = codes[np.minimum(pos[::3, None], n - L) + np.arange(L)]
    want = np.asarray(jax_seed.hamming_to_text(jnp.asarray(words), jnp.asarray(pos),
                                               jax_seed.pack_query_words(jnp.asarray(qs)), L))
    qwords = seed.pack_query_words(torch.from_numpy(qs))
    tw = torch.from_numpy(words.view(np.int32))
    p = torch.from_numpy(pos.astype(np.int64))[:, None]
    valid = torch.ones_like(p, dtype=torch.bool)
    got = seed.hamming_to_text_reference(tw, p, qwords, valid, L)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got[:, 0].numpy(), want)
    inside = pos <= n - L
    np.testing.assert_array_equal(want[inside], (codes[pos[inside, None] + np.arange(L)] != qs[inside]).sum(1))
    valid[::2] = False
    masked = seed.hamming_to_text(tw, p, qwords, valid, L)[:, 0].numpy()  # the wrapper, on the CPU
    np.testing.assert_array_equal(masked, np.where(np.arange(96) % 2, want, L + 1))


def test_hamming_wrapper_checks_its_inputs():
    tw = torch.zeros(4, dtype=torch.int32)
    p = torch.zeros((2, 3), dtype=torch.int64)
    q = torch.zeros((2, 2), dtype=torch.int64)
    v = torch.ones((2, 3), dtype=torch.bool)
    with pytest.raises(ValueError, match="read words for L=17"):
        seed.hamming_to_text(tw, p, q[:, :1].contiguous(), v, 17)
    with pytest.raises(ValueError, match="valid must be bool"):
        seed.hamming_to_text(tw, p, q, v[:, :2].contiguous(), 17)
    with pytest.raises(ValueError, match="pos must be int64"):
        seed.hamming_to_text(tw, p.int(), q, v, 17)


@pytest.mark.parametrize("m", [1, 2, 3])
# (30, 2, 8): at m = 3 the 6-base seeds are shorter than the LUT and start
# from the full interval on the same tables, as tpufm's LUT-free seed scan
@pytest.mark.parametrize("L,k,lut", [(30, 3, 0), (61, 1, 6), (120, 2, 6), (30, 2, 8)])
def test_seed_extend_equals_tpufm_and_oracle(m, L, k, lut):
    codes, jidx, jloc, idx, loc = _setup(k=k)
    qs = _planted(codes, L, m, seed_=m * L + k)
    want = jax_seed.SeedExtendEngine(jidx, jloc, codes, mismatches=m, seed_hits=64, max_hits=8,
                                     lut_m=lut).locate_approx(qs)
    eng = seed.SeedExtendEngine(idx, loc, codes, mismatches=m, seed_hits=64, max_hits=8, lut_m=lut,
                                device="cpu")
    got = eng.locate_approx(qs)
    _equal(got, want)
    assert not got[2].any(), "random text should not overflow seed_hits=64"
    counts, positions = seed.seed_extend_oracle(codes, qs, m)
    jcounts, jpositions = jax_seed.seed_extend_oracle(codes, qs, m)
    np.testing.assert_array_equal(counts, jcounts)
    np.testing.assert_array_equal(got[1], counts)
    for row, p, jp in zip(got[0], positions, jpositions):
        np.testing.assert_array_equal(p, jp)
        np.testing.assert_array_equal(row[row != SENT], p[:8])
    _equal(eng.count_approx(qs), (got[1], got[2]))


@pytest.mark.parametrize("budget", ["set", "off"])
@pytest.mark.parametrize("m", [2, 3])
def test_seed_extend_equals_tpufm_with_budgets(m, budget):
    """tpufm's walk and verify budgets (512 lanes: its compacted path; 0:
    none) do not change its results, and the port, which has neither,
    gives the same."""
    codes, jidx, jloc, idx, loc = _setup(k=2, n=2500)
    qs = _planted(codes, 30, m, seed_=m, n_sampled=20)
    b = 512 if budget == "set" else 0
    want = jax_seed.SeedExtendEngine(jidx, jloc, codes, mismatches=m, seed_hits=64, max_hits=8,
                                     walk_budget=b, verify_budget=b).locate_approx(qs)
    got = seed.SeedExtendEngine(idx, loc, codes, mismatches=m, seed_hits=64, max_hits=8,
                                device="cpu").locate_approx(qs)
    _equal(got, want)


def test_seed_extend_edges_equal_tpufm():
    """A seed hit left of its offset (the candidate start would be negative),
    a window at the last valid start n - L, one a base past it, and a read
    that occurs twice, with prepacked text words."""
    codes, jidx, jloc, idx, loc = _setup(k=2, n=2500)
    n, L, m = 2500, 30, 2
    rng = np.random.default_rng(5)
    qs = [
        np.concatenate([rng.integers(0, 4, size=10, dtype=np.uint8), codes[:20]]),  # seeds 1, 2 at 0, 10
        codes[n - L:].copy(),
        np.concatenate([codes[n - L + 1:], [0]]).astype(np.uint8),
        codes[100:130].copy(),
    ]
    qs[1][[3, 17]] ^= 1  # two substitutions at the last valid start
    qs = np.stack(qs)
    words = seed.pack_text_words(codes)
    want = jax_seed.SeedExtendEngine(jidx, jloc, words, mismatches=m, max_hits=8).locate_approx(qs)
    got = seed.SeedExtendEngine(idx, loc, words, mismatches=m, max_hits=8, device="cpu").locate_approx(qs)
    _equal(got, want)
    assert n - L in got[0][1] and 100 in got[0][3]
    assert (got[0][2][got[0][2] != SENT] <= n - L).all()


def test_seed_overflow_flagged_on_repeats():
    """A tiled repeat: every seed interval is the whole repeat family, wider
    than seed_hits; the flag and the lower-bound list equal tpufm's."""
    tile = np.random.default_rng(1234).integers(0, 4, size=16, dtype=np.uint8)
    codes, jidx, jloc, idx, loc = _setup(k=2, codes=np.tile(tile, 100))
    qs = codes[None, :48].copy()
    want = jax_seed.SeedExtendEngine(jidx, jloc, codes, mismatches=2, seed_hits=4).locate_approx(qs)
    got = seed.SeedExtendEngine(idx, loc, codes, mismatches=2, seed_hits=4, device="cpu").locate_approx(qs)
    _equal(got, want)
    assert got[2][0]
    counts, _ = seed.seed_extend_oracle(codes, qs, 2)
    assert 0 < got[1][0] <= counts[0]
    wins = np.lib.stride_tricks.sliding_window_view(codes, 48)
    for p in got[0][0][got[0][0] != SENT]:
        assert (wins[p] != qs[0]).sum() <= 2


def test_seed_extend_too_short_raises_as_tpufm():
    codes, jidx, jloc, idx, loc = _setup(k=3)
    qs = np.random.default_rng(2).integers(0, 4, size=(4, 10), dtype=np.uint8)
    with pytest.raises(ValueError, match="too short") as theirs:
        jax_seed.SeedExtendEngine(jidx, jloc, codes, mismatches=3).locate_approx(qs)
    with pytest.raises(ValueError, match="too short") as ours:
        seed.SeedExtendEngine(idx, loc, codes, mismatches=3, device="cpu").locate_approx(qs)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="mismatches >= 1"):
        seed.SeedExtendEngine(idx, loc, codes, mismatches=0, device="cpu")


def test_seed_extend_empty_batch_and_waves():
    codes, jidx, jloc, idx, loc = _setup(k=3, n=2000)
    eng = seed.SeedExtendEngine(idx, loc, codes, mismatches=2, seed_hits=64, device="cpu")
    empty = eng.locate_approx(np.zeros((0, 30), np.uint8))
    _equal(empty, jax_seed.SeedExtendEngine(jidx, jloc, codes, mismatches=2).locate_approx(
        np.zeros((0, 30), np.uint8)))
    qs = _planted(codes, 30, 2, seed_=9, n_sampled=40, n_random=16)
    _equal(eng.locate_approx(qs, wave=13), eng.locate_approx(qs))


@pytest.mark.parametrize("L,lut,uses_lut", [(30, 8, False), (30, 6, True), (31, 0, False)])
def test_seed_scan_takes_the_lut_only_for_seeds_as_long(monkeypatch, L, lut, uses_lut):
    """tpufm starts a seed from the LUT only when Ls >= lut_m (seed.py:154);
    the port's seed scan asks its search for the same, on the same tables
    (Ls = 6 at m=3, k=2)."""
    from tpufm_torch.engine.search import SearchEngine

    codes, _, _, idx, loc = _setup(k=2, n=1500)
    seen = []
    search = SearchEngine.search_device
    monkeypatch.setattr(SearchEngine, "search_device",
                        lambda self, q, step=None, use_lut=True: seen.append((q.shape[1], use_lut))
                        or search(self, q, step, use_lut))
    eng = seed.SeedExtendEngine(idx, loc, codes, mismatches=3, lut_m=lut, device="cpu")
    qs = _planted(codes, L, 3, seed_=L, n_sampled=8, n_random=0)
    eng.locate_approx(qs)
    assert seen == [(6, uses_lut)]
    counts, _ = seed.seed_extend_oracle(codes, qs, 3)
    np.testing.assert_array_equal(eng.count_approx(qs)[0], counts)
