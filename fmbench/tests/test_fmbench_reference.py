"""The plain reference against brute force on tiny texts with repeats."""

import bisect

import numpy as np
import pytest
import torch

from fmbench.reference import FULL, SuffixOrder


def brute(text: np.ndarray, reads: np.ndarray, max_hits: int):
    """Intervals, first positions and Hamming <= 1 counts by sorting every suffix."""
    t = bytes((text + 1).tolist())
    order = sorted(range(len(t) + 1), key=lambda i: t[i:])
    keys = [t[i:] for i in order]
    ivs, poss, counts = [], [], []
    for r in reads:
        p = bytes((r + 1).tolist())
        lo, hi = bisect.bisect_left(keys, p), bisect.bisect_left(keys, p + b"\xff")
        ivs.append((lo, hi))
        first = [order[j] for j in range(lo, min(hi, lo + max_hits))]
        poss.append(first + [FULL] * (max_hits - len(first)))
        L = len(r)
        counts.append(sum(int((text[s:s + L] != r).sum() <= 1) for s in range(len(text) - L + 1)))
    return np.array(ivs), np.array(poss), np.array(counts)


def texts_and_reads(seed: int, L: int):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 4, 2500).astype(np.uint8)
    seg = t[100:300].copy()
    t[900:1100] = seg            # exact repeats
    t[1500:1700] = seg
    t[2000:2200] = seg
    t[2050] ^= 1                 # a near repeat
    t[2440:] = 0                 # a run of one base at the end
    starts = rng.integers(0, len(t) - L + 1, 150)
    reads = t[starts[:, None] + np.arange(L)].copy()
    sub = rng.random(150) < 0.5
    reads[sub, rng.integers(0, L, 150)[sub]] ^= 2
    extra = [t[100:100 + L], t[2440:2440 + L] if 2440 + L <= len(t) else t[-L:], t[-L:],
             rng.integers(0, 4, L).astype(np.uint8)]
    return t, np.concatenate([reads, np.stack(extra)])


@pytest.mark.parametrize("seed,L", [(1, 60), (2, 60), (3, 120)])
def test_reference_against_brute_force(seed, L):
    t, reads = texts_and_reads(seed, L)
    ref = SuffixOrder(torch.from_numpy(t), t)
    q = torch.from_numpy(reads)
    biv, bpos, bcount = brute(t, reads, 4)
    iv, pos = ref.locate(q, 4)
    np.testing.assert_array_equal(ref.intervals(q).numpy(), biv)
    np.testing.assert_array_equal(iv.numpy(), biv)
    np.testing.assert_array_equal(pos.numpy(), bpos)
    np.testing.assert_array_equal(ref.counts(q).numpy(), biv[:, 1] - biv[:, 0])
    np.testing.assert_array_equal(ref.counts_hamming1(q).numpy(), bcount)


def test_reference_agrees_with_the_programs_host_oracle():
    """A second witness: the program's numpy search oracle on its host index."""
    from tpufm_torch.host.index import IndexConfig, build_index
    from tpufm_torch.host.oracle import search_oracle

    rng = np.random.default_rng(7)
    t = rng.integers(0, 4, 5000).astype(np.uint8)
    starts = rng.integers(0, 5000 - 48 + 1, 64)
    reads = t[starts[:, None] + np.arange(48)]
    ref = SuffixOrder(torch.from_numpy(t), t)
    got = search_oracle(build_index(t, IndexConfig(k=3, d=64)), reads)
    np.testing.assert_array_equal(ref.intervals(torch.from_numpy(reads)).numpy(), np.asarray(got, dtype=np.int64))


def test_reference_refuses_reads_shorter_than_its_key():
    t = np.zeros(100, np.uint8)
    ref = SuffixOrder(torch.from_numpy(t), t)
    with pytest.raises(ValueError):
        ref.intervals(torch.zeros((1, 20), dtype=torch.uint8))


@pytest.mark.parametrize("rate", [0.0, 0.02, 0.1])
def test_reads_carry_the_substitutions_their_mix_asks_for(rate):
    from fmbench import gen

    text = gen.make_text(50_000, 9, torch.device("cpu"))
    start = gen.generator(9, gen.READS, torch.device("cpu"))
    reads = gen.make_reads(text, 120, 3000, start, rate)
    # where each read came from: its starts, drawn first from the same stream
    starts = torch.randint(0, 50_000 - 120 + 1, (3000,), generator=gen.generator(9, gen.READS, torch.device("cpu")))
    source = text.unfold(0, 120, 1)[starts]
    subs = (reads != source).sum(1).double()
    assert int(reads.max()) <= 3
    # a binomial(120, rate): its mean and its share of reads with none
    assert abs(float(subs.mean()) - 120 * rate) < 4 * (120 * rate * (1 - rate) / 3000) ** 0.5 + 1e-9
    assert abs(float((subs == 0).double().mean()) - (1 - rate) ** 120) < 0.03
    ref = SuffixOrder(text, text.numpy())
    near = ref.counts_hamming1(reads)
    # within distance 1 of the text exactly where at most one base was substituted
    assert torch.equal(near >= 1, subs <= 1)
    again = gen.make_reads(text, 120, 3000, gen.generator(9, gen.READS, torch.device("cpu")), rate)
    assert torch.equal(reads, again)


def test_a_substitution_rate_outside_0_to_1_is_refused():
    from fmbench import gen

    text = gen.make_text(1000, 9, torch.device("cpu"))
    for rate in (-0.1, 1.0):
        with pytest.raises(ValueError):
            gen.make_reads(text, 120, 10, gen.generator(9, gen.READS, torch.device("cpu")), rate)
