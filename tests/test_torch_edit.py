"""Edit-distance seed-and-extend in the port against tpufm: ``build_peq``,
the Myers scan's plain version against ``make_myers_verify_fn(L, E)`` (L in
{32, 33, 64, 120, 151}, E in {1, 2, 3}, random windows, start ranges and
validity), ``EditExtendEngine`` on the CPU against tpufm's (with its budgets
set and disabled) and against the DP oracle (every site within E edits, a
site within 2E of each planted origin), and the windowed DP the bench and
the smoke run use against the full oracle. Every value is an integer and
compares exactly (tolerance 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufm.config import IndexConfig as JaxIndexConfig
from tpufm.engine import edit as jax_edit
from tpufm.engine.seed import pack_text_words
from tpufm.index.builder import build_index as jax_build_index
from tpufm.index.locate import build_locate as jax_build_locate
from tpufm.index.suffix_array import suffix_array
from tpufm_torch.engine import edit
from tpufm_torch.host.index import IndexConfig, build_index
from tpufm_torch.host.locate import build_locate

SENT = 0xFFFFFFFF


def _setup(k=2, d=64, n=3000, s=8, seed_=1234, codes=None):
    if codes is None:
        codes = np.random.default_rng(seed_).integers(0, 4, size=n, dtype=np.uint8)
    sa = suffix_array(codes, method="doubling")
    return (codes, jax_build_index(codes, JaxIndexConfig(k=k, d=d), sa=sa),
            jax_build_locate(codes, sample_rate=s, d=d, sa=sa),
            build_index(codes, IndexConfig(k=k, d=d), sa=sa), build_locate(codes, sample_rate=s, d=d, sa=sa))


def _mutate(codes, s0, L, E, rng):
    """L bases from s0 after E random edits (substitution, deletion or
    insertion) of codes[s0 : s0 + L + E]."""
    w = list(codes[s0 : s0 + L + E])
    for _ in range(E):
        op = rng.integers(0, 3)
        p = int(rng.integers(0, len(w) - 1))
        if op == 0:
            w[p] = (w[p] + int(rng.integers(1, 4))) & 3
        elif op == 1:
            del w[p]
        else:
            w.insert(p, int(rng.integers(0, 4)))
    return np.array(w[:L], np.uint8)


def _indel_reads(codes, L, E, seed_, n_sampled=20, n_random=6):
    """(reads, origins): tests/test_edit.py's ``_indel_reads``; origin -1
    for the random reads."""
    rng = np.random.default_rng(seed_)
    origins = [int(rng.integers(0, len(codes) - L - E)) for _ in range(n_sampled)]
    reads = [_mutate(codes, s0, L, E, rng) for s0 in origins]
    reads += [rng.integers(0, 4, size=L, dtype=np.uint8) for _ in range(n_random)]
    return np.stack(reads), np.asarray(origins + [-1] * n_random)


def _equal(got, want):
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("L", [1, 17, 32, 33, 120, 151])
def test_build_peq_equals_tpufm(L):
    qs = np.random.default_rng(L).integers(0, 4, size=(6, L), dtype=np.uint8)
    W = -(-L // 32)
    got = edit.build_peq(torch.from_numpy(qs), W).numpy()
    want = np.asarray(jax_edit.build_peq(jnp.asarray(qs), W))
    assert got.shape == want.shape and got.astype(np.uint32).tobytes() == want.tobytes()
    assert (got >= 0).all() and (got < 1 << 32).all()


@pytest.mark.parametrize("E", [1, 2, 3])
@pytest.mark.parametrize("L", [32, 33, 64, 120, 151])
def test_myers_reference_equals_tpufm(L, E):
    """Random lo (start ranges at the text's start, across it and past its
    end, where characters match nothing), hi >= lo within 2E, and validity;
    half the reads are mutated text windows, so small distances occur."""
    rng = np.random.default_rng(L * 10 + E)
    n = 700
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    words = pack_text_words(codes)
    B, C = 6, 7
    qs = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    a = rng.integers(-E, n - 1 + E + 1, size=(B, C))
    a[0, :3] = [n - 1 + E, n - 1, -E]
    for b in range(1, B, 2):
        s0 = int(rng.integers(0, n - L - E))
        qs[b] = _mutate(codes, s0, L, E, rng)
        a[b, 1:] = s0
    lo = np.maximum(a - E, 0).astype(np.uint32)
    hi = np.minimum(a + E, n - 1).astype(np.uint32)
    valid = rng.random((B, C)) < 0.8
    W = -(-L // 32)
    jpeq = jax_edit.build_peq(jnp.asarray(qs[:, ::-1].copy()), W)
    want = jax.jit(jax_edit.make_myers_verify_fn(L, E))(
        jnp.asarray(words), jnp.uint32(n), jpeq[:, None], jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(valid))
    peq = edit.build_peq(torch.from_numpy(qs[:, ::-1].copy()), W)
    args = [torch.from_numpy(x.astype(np.int64)) for x in (lo, hi)]
    got = edit.myers_verify(torch.from_numpy(words.view(np.int32)), n, peq, *args,
                            torch.from_numpy(valid), L, E)  # the wrapper: the plain version on the CPU
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.int64
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]).astype(np.int64))
    assert (got[0].numpy()[1::2][valid[1::2]] <= E).any()


def test_myers_wrapper_checks_its_inputs():
    tw = torch.zeros(8, dtype=torch.int32)
    lo = torch.zeros((2, 3), dtype=torch.int64)
    v = torch.ones((2, 3), dtype=torch.bool)
    with pytest.raises(ValueError, match=r"peq must be int64 \[2, 4, 2\]"):
        edit.myers_verify(tw, 50, torch.zeros((2, 4, 1), dtype=torch.int64), lo, lo, v, 33, 1)
    with pytest.raises(ValueError, match="lo and hi"):
        edit.myers_verify(tw, 50, torch.zeros((2, 4, 1), dtype=torch.int64), lo, lo[:1], v, 20, 1)


@pytest.mark.parametrize("E,L,k,lut", [(1, 24, 2, 0), (2, 36, 3, 6), (3, 48, 2, 4), (1, 61, 1, 6),
                                       (2, 120, 3, 6), (3, 151, 2, 0)])
def test_edit_extend_equals_tpufm_and_oracle(E, L, k, lut):
    codes, jidx, jloc, idx, loc = _setup(k=k)
    qs, origins = _indel_reads(codes, L, E, seed_=E * L + k)
    want = jax_edit.EditExtendEngine(jidx, jloc, codes, edits=E, seed_hits=64, max_hits=8,
                                     lut_m=lut).locate_edits(qs)
    got = edit.EditExtendEngine(idx, loc, codes, edits=E, seed_hits=64, max_hits=8, lut_m=lut,
                                device="cpu").locate_edits(qs)
    _equal(got, want)
    pos, counts, overflow = got
    assert not overflow.any(), "random text should not overflow seed_hits=64"
    oracle = edit.edit_extend_oracle(codes, qs, E)
    np.testing.assert_array_equal(oracle, jax_edit.edit_extend_oracle(codes, qs, E))
    for i in range(qs.shape[0]):
        sites = pos[i][pos[i] != SENT].astype(np.int64)
        assert (np.diff(sites) > 0).all() and counts[i] >= sites.size
        assert (oracle[i, sites] <= E).all()  # sound
        if origins[i] >= 0:  # sensitive: a site within 2E of the origin
            assert sites.size and np.abs(sites - origins[i]).min() <= 2 * E


@pytest.mark.parametrize("budget", ["set", "off"])
@pytest.mark.parametrize("E", [1, 2])
def test_edit_extend_equals_tpufm_with_budgets(E, budget):
    codes, jidx, jloc, idx, loc = _setup(n=2500)
    qs, _ = _indel_reads(codes, 33, E, seed_=E, n_sampled=16)
    b = 512 if budget == "set" else 0
    want = jax_edit.EditExtendEngine(jidx, jloc, codes, edits=E, seed_hits=64, max_hits=8,
                                     walk_budget=b, verify_budget=b).locate_edits(qs)
    got = edit.EditExtendEngine(idx, loc, codes, edits=E, seed_hits=64, max_hits=8,
                                device="cpu").locate_edits(qs)
    _equal(got, want)


def test_edit_extend_edges_equal_tpufm():
    """Anchors at the text's ends: a seed hit left of its offset by more
    than E (no candidate), the last E + 1 windows, and an exact read."""
    codes, jidx, jloc, idx, loc = _setup(n=2500)
    n, L, E = 2500, 30, 2
    rng = np.random.default_rng(8)
    qs = np.stack([
        np.concatenate([rng.integers(0, 4, size=15, dtype=np.uint8), codes[:15]]),  # seed 1 at 0 < 15 - E
        np.concatenate([rng.integers(0, 4, size=11, dtype=np.uint8), codes[:19]]),
        codes[n - L:].copy(),
        np.concatenate([codes[n - L + 2:], [1, 2]]).astype(np.uint8),
        codes[700:730].copy(),
    ])
    want = jax_edit.EditExtendEngine(jidx, jloc, codes, edits=E, max_hits=8).locate_edits(qs)
    got = edit.EditExtendEngine(idx, loc, codes, edits=E, max_hits=8, device="cpu").locate_edits(qs)
    _equal(got, want)
    assert 700 in got[0][4] and n - L in got[0][2]


def test_edit_overflow_flagged_on_repeats():
    tile = np.random.default_rng(1234).integers(0, 4, size=16, dtype=np.uint8)
    codes, jidx, jloc, idx, loc = _setup(codes=np.tile(tile, 100))
    qs = codes[None, :48].copy()
    want = jax_edit.EditExtendEngine(jidx, jloc, codes, edits=2, seed_hits=4).locate_edits(qs)
    got = edit.EditExtendEngine(idx, loc, codes, edits=2, seed_hits=4, device="cpu").locate_edits(qs)
    _equal(got, want)
    assert got[2][0]
    oracle = edit.edit_extend_oracle(codes, qs, 2)
    for s in got[0][0][got[0][0] != SENT]:
        assert oracle[0, int(s)] <= 2


def test_edit_extend_too_short_empty_and_waves():
    codes, jidx, jloc, idx, loc = _setup(k=3)
    short = np.random.default_rng(3).integers(0, 4, size=(4, 10), dtype=np.uint8)
    with pytest.raises(ValueError, match="too short") as theirs:
        jax_edit.EditExtendEngine(jidx, jloc, codes, edits=3).locate_edits(short)
    eng = edit.EditExtendEngine(idx, loc, codes, edits=3, device="cpu")
    with pytest.raises(ValueError, match="too short") as ours:
        eng.locate_edits(short)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="edits >= 1"):
        edit.EditExtendEngine(idx, loc, codes, edits=0, device="cpu")
    _equal(eng.locate_edits(np.zeros((0, 30), np.uint8)),
           jax_edit.EditExtendEngine(jidx, jloc, codes, edits=3).locate_edits(np.zeros((0, 30), np.uint8)))
    qs, _ = _indel_reads(codes, 30, 2, seed_=4, n_sampled=30, n_random=10)
    eng2 = edit.EditExtendEngine(idx, loc, codes, edits=2, seed_hits=64, device="cpu")
    _equal(eng2.locate_edits(qs, wave=13), eng2.locate_edits(qs))


@pytest.mark.parametrize("E", [1, 2, 3])
def test_windowed_dp_verdicts_equal_the_full_oracle(E):
    """The bench's windowed DP at every start of the text, the last ones
    included: the same <= E verdicts as the full oracle, and the same
    distance wherever that is <= E."""
    rng = np.random.default_rng(E)
    n, L = 400, 24
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    qs = np.stack([_mutate(codes, int(s), L, E, rng) for s in rng.integers(0, n - L - E, size=5)]
                  + [codes[n - L:].copy()])
    full = jax_edit.edit_extend_oracle(codes, qs, E)
    starts = np.arange(n)
    got = edit.windowed_edit_dist(torch.from_numpy(codes), torch.from_numpy(np.repeat(qs, n, axis=0)),
                                  torch.from_numpy(np.tile(starts, len(qs))), E).numpy().reshape(len(qs), n)
    np.testing.assert_array_equal(got <= E, full <= E)
    np.testing.assert_array_equal(np.where(full <= E, got, 0), np.where(full <= E, full, 0))
    assert (full <= E).sum() > len(qs)
