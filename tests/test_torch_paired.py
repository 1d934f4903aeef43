"""Paired-end placement in the port against tpufm: ``pair_join`` against
``make_pair_fn`` (overlapping mates allowed, crossing mates rejected, rows
with more proper pairs than max_pairs), ``PairedEndEngine`` on the CPU
against tpufm's with each position source (exact, Hamming 1, seed-and-
extend at m=2, Myers at E=1) and with mates of two lengths, and both
against ``pair_oracle``. Pairs, strands, counts and flags are integers and
compare exactly (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufm.config import IndexConfig as JaxIndexConfig
from tpufm.engine import paired as jax_paired
from tpufm.index.builder import build_index as jax_build_index
from tpufm.index.locate import build_locate as jax_build_locate
from tpufm.index.suffix_array import suffix_array
from tpufm.utils.encoding import reverse_complement
from tpufm_torch.engine import paired
from tpufm_torch.host.index import IndexConfig, build_index
from tpufm_torch.host.locate import build_locate

SENT = 0xFFFFFFFF


def _setup(k=2, d=64, n=4000, s=8, seed_=1234):
    codes = np.random.default_rng(seed_).integers(0, 4, size=n, dtype=np.uint8)
    sa = suffix_array(codes, method="doubling")
    return (codes, jax_build_index(codes, JaxIndexConfig(k=k, d=d), sa=sa),
            jax_build_locate(codes, sample_rate=s, d=d, sa=sa),
            build_index(codes, IndexConfig(k=k, d=d), sa=sa), build_locate(codes, sample_rate=s, d=d, sa=sa))


def _plant_pairs(codes, L1, L2, imin, imax, B, seed_):
    """tests/test_paired.py's fragments on alternating strands: (r1, r2,
    [(left, right, strand)])."""
    rng = np.random.default_rng(seed_)
    r1 = np.empty((B, L1), np.uint8)
    r2 = np.empty((B, L2), np.uint8)
    want = []
    for i in range(B):
        f = int(rng.integers(max(imin, L1, L2), imax + 1))
        s0 = int(rng.integers(0, len(codes) - f))
        if i % 2 == 0:
            r1[i], r2[i] = codes[s0 : s0 + L1], reverse_complement(codes[s0 + f - L2 : s0 + f][None])[0]
            want.append((s0, s0 + f - L2, 0))
        else:
            r1[i] = reverse_complement(codes[s0 + f - L1 : s0 + f][None])[0]
            r2[i] = codes[s0 : s0 + L2]
            want.append((s0, s0 + f - L1, 1))
    return r1, r2, want


def _equal(got, want):
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _triples(pairs, strand):
    return {(int(l), int(r), int(s)) for (l, r), s in zip(pairs, strand) if l != SENT}


@pytest.mark.parametrize("P", [1, 4, 32])
@pytest.mark.parametrize("L1,L2,imin,imax", [(20, 20, 0, 100), (24, 16, 30, 60), (20, 20, 25, 25)])
def test_pair_join_equals_tpufm(L1, L2, imin, imax, P):
    """Random position rows with padding, plus an overlapping pair (fragment
    below L1 + L2: proper), a crossing pair (right start left of the left
    start: its uint32 fragment wraps far past imax) and a pair at fragment
    exactly max(imin, L): proper."""
    rng = np.random.default_rng(L1 + L2 + P + imin)
    B, H1, H2 = 12, 6, 5
    rows = [rng.integers(0, 300, size=(B, h)).astype(np.uint32) for h in (H1, H2, H2, H1)]
    for r in rows:
        r[rng.random(r.shape) < 0.3] = SENT
    p1f, p2r, p1r, p2f = rows
    p1f[0, 0], p2r[0, 0] = 100, 100 + 30 - L2  # overlapping: fragment 30
    p1f[1, 0], p2r[1, 0] = 100, 90  # crossing: 90 + L2 - 100 wraps below 0
    p2f[2, 0], p1r[2, 0] = 50, 50 + max(imin, L1) - L1  # fragment exactly max(imin, L1)
    want = jax_paired.make_pair_fn(L1, L2, imin, imax, P)(*map(jnp.asarray, (p1f, p2r, p1r, p2f)))
    got = paired.pair_join(*(torch.from_numpy(r.astype(np.int64)) for r in rows), L1, L2, imin, imax, P)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]).astype(np.int64))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[1].dtype == torch.uint8
    if imax >= 30:
        assert (100, 100 + 30 - L2, 0) in _triples(got[0][0].numpy(), got[1][0].numpy())
    assert (100, 90, 0) not in _triples(got[0][1].numpy(), got[1][1].numpy())
    if P >= 4:
        assert (50, 50 + max(imin, L1) - L1, 1) in _triples(got[0][2].numpy(), got[1][2].numpy())


SOURCES = {"exact": {}, "m1": {"mismatches": 1}, "m2": {"mismatches": 2}, "e1": {"edits": 1}}


@pytest.mark.parametrize("L1,L2", [(24, 24), (24, 18)])
@pytest.mark.parametrize("source", list(SOURCES))
def test_paired_engine_equals_tpufm(source, L1, L2):
    """Planted fragments, each with one substitution in a mate for the
    approximate sources, and random pairs; mates of one length take one
    4B-read batch, of two lengths two batches."""
    codes, jidx, jloc, idx, loc = _setup()
    imin, imax = 60, 250
    r1, r2, truth = _plant_pairs(codes, L1, L2, imin, imax, 20, seed_=L1 + L2)
    if source != "exact":
        r1[::3, 7] = (r1[::3, 7] + 1) % 4
    rng = np.random.default_rng(3)
    r1 = np.concatenate([r1, rng.integers(0, 4, size=(4, L1), dtype=np.uint8)])
    r2 = np.concatenate([r2, rng.integers(0, 4, size=(4, L2), dtype=np.uint8)])
    kw = dict(SOURCES[source], max_hits=8, max_pairs=4)
    if source in ("m2", "e1"):
        kw["text"] = codes
    want = jax_paired.PairedEndEngine(jidx, jloc, imin, imax, **kw).pair(r1, r2)
    got = paired.PairedEndEngine(idx, loc, imin, imax, device="cpu", **kw).pair(r1, r2)
    _equal(got, want)
    for i, t in enumerate(truth):
        if source != "exact" or i % 3:
            assert t in _triples(got[0][i], got[1][i])


def test_paired_matches_the_oracle():
    """Exact pairing against the exhaustive cross join (tpufm's oracle and
    the port's, its scans on the CPU, equal)."""
    codes, jidx, jloc, idx, loc = _setup(n=3000)
    imin, imax, L = 40, 150, 16
    r1, r2, _ = _plant_pairs(codes, L, L, imin, imax, 12, seed_=5)
    rng = np.random.default_rng(6)
    r1 = np.concatenate([r1, rng.integers(0, 4, size=(6, L), dtype=np.uint8)])
    r2 = np.concatenate([r2, rng.integers(0, 4, size=(6, L), dtype=np.uint8)])
    pairs, strand, counts, _ = paired.PairedEndEngine(idx, loc, imin, imax, max_pairs=8,
                                                      device="cpu").pair(r1, r2)
    want = paired.pair_oracle(codes, r1, r2, imin, imax)
    assert want == jax_paired.pair_oracle(codes, r1, r2, imin, imax)
    for i in range(r1.shape[0]):
        assert counts[i] == len(want[i])
        got = _triples(pairs[i], strand[i])
        assert got == set(want[i]) if counts[i] <= 8 else got <= set(want[i])


def test_paired_overlap_allowed_crossing_rejected():
    codes, jidx, jloc, idx, loc = _setup()
    L, s0 = 20, 1000
    r1 = codes[None, s0 : s0 + L].copy()
    overlap = reverse_complement(codes[s0 + 30 - L : s0 + 30][None])  # fragment 30 < 2L
    crossing = reverse_complement(codes[s0 - 15 : s0 + 5][None])
    eng = paired.PairedEndEngine(idx, loc, 0, 100, max_hits=8, device="cpu")
    jeng = jax_paired.PairedEndEngine(jidx, jloc, 0, 100, max_hits=8)
    for r2, proper in ((overlap, True), (crossing, False)):
        got = eng.pair(r1, r2)
        _equal(got, jeng.pair(r1, r2))
        assert (got[2][0] >= 1) == proper
        assert got[2][0] == len(paired.pair_oracle(codes, r1, r2, 0, 100)[0])


def test_paired_errors_and_empty_batch_as_tpufm():
    codes, jidx, jloc, idx, loc = _setup()
    for kw in ({"imin": 9, "imax": 8}, {"imin": 0, "imax": 9, "mismatches": 1, "edits": 1},
               {"imin": 0, "imax": 9, "mismatches": 2}, {"imin": 0, "imax": 9, "edits": 1}):
        with pytest.raises(ValueError) as theirs:
            jax_paired.PairedEndEngine(jidx, jloc, **kw)
        with pytest.raises(ValueError) as ours:
            paired.PairedEndEngine(idx, loc, device="cpu", **kw)
        assert str(ours.value).split(";")[0] == str(theirs.value).split(";")[0]
    eng = paired.PairedEndEngine(idx, loc, 60, 200, device="cpu")
    empty = np.zeros((0, 20), np.uint8)
    _equal(eng.pair(empty, empty), jax_paired.PairedEndEngine(jidx, jloc, 60, 200).pair(empty, empty))
    with pytest.raises(ValueError, match="differ"):
        eng.pair(np.zeros((2, 20), np.uint8), np.zeros((3, 20), np.uint8))


def test_paired_overflow_on_a_full_row():
    """The m=1 source has no truncation signal: a full position row flags
    its pair, as tpufm does; so does the exact source's wide interval."""
    codes, jidx, jloc, idx, loc = _setup()
    qs = np.stack([codes[s : s + 4] for s in range(0, 80, 4)])  # 4 bp reads: ~15 hits each
    for kw in ({}, {"mismatches": 1}):
        want = jax_paired.PairedEndEngine(jidx, jloc, 0, 400, max_hits=2, **kw).pair(qs, qs)
        got = paired.PairedEndEngine(idx, loc, 0, 400, max_hits=2, device="cpu", **kw).pair(qs, qs)
        _equal(got, want)
        assert got[3].all()
