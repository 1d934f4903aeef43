"""The mesh suffix sort (tpufm_torch.index.sa_sharded) against tpufm's
(tpufm/index/sa_sharded.py) on the same texts, the port on 4 and 8 CPU
shards and tpufm on as many of its virtual CPU devices (tests/conftest.py):
random texts of every small length (0, 1, fewer than PACK lanes a shard),
a repetitive one ('A' * n, every doubling round taken), symbols up to 6,
the refusal of symbol 7; ``suffix_array(method="sharded")``; the int32
size limit through its check; each round's collectives against the closed
form ``round_collectives``; and the collectives' ``ppermute(xs, perm)``
against the ring form. Suffix arrays are integers and compare exactly
(tolerance 0)."""

import functools

import numpy as np
import pytest
import torch

from tpufm.index.sa_sharded import suffix_array_sharded as jax_suffix_array_sharded
from tpufm.index.suffix_array import suffix_array as jax_suffix_array
from tpufm.parallel.mesh import make_mesh as jax_make_mesh
from tpufm_torch.host.suffix_array import suffix_array
from tpufm_torch.index import sa_sharded
from tpufm_torch.index.sa_sharded import round_collectives, suffix_array_sharded
from tpufm_torch.parallel import collectives as coll
from tpufm_torch.parallel.mesh import make_mesh


def _text(kind: str, n: int) -> np.ndarray:
    rng = np.random.default_rng(n)
    if kind == "random":
        return rng.integers(0, 4, size=n, dtype=np.uint8)
    if kind == "repeat":
        return np.zeros(n, np.uint8)
    return rng.integers(0, 7, size=n, dtype=np.uint8)  # symbols 0-6


@functools.lru_cache(maxsize=None)
def _jax_sa(kind: str, n: int, D: int) -> np.ndarray:
    return jax_suffix_array_sharded(_text(kind, n), jax_make_mesh(D))


@pytest.mark.parametrize("D", [4, 8])
@pytest.mark.parametrize("kind,n", [("random", 0), ("random", 1), ("random", 7), ("random", 39), ("random", 81),
                                    ("random", 1000), ("random", 4097), ("repeat", 300), ("sym6", 2000)])
def test_suffix_array_sharded_matches_tpufm(kind, n, D):
    """The port's sharded sort on D CPU shards equals tpufm's on D devices
    and the host SA-IS: int64 [n+1], result[0] == n (n < 10 D leaves whole
    shards of pads; 'A' * 300 takes every doubling round)."""
    codes = _text(kind, n)
    got = suffix_array_sharded(codes, make_mesh(D, device="cpu"))
    want = _jax_sa(kind, n, D)
    assert got.dtype == np.int64 and np.array_equal(got, want)
    assert np.array_equal(got, jax_suffix_array(codes, method="doubling")) and got[0] == n


def test_suffix_array_sharded_refuses_symbol_7():
    codes = np.array([0, 1, 7, 2], np.uint8)
    with pytest.raises(ValueError) as jax_err:
        jax_suffix_array_sharded(codes, jax_make_mesh(4))
    with pytest.raises(ValueError) as torch_err:
        suffix_array_sharded(codes, make_mesh(4, device="cpu"))
    assert str(torch_err.value) == str(jax_err.value)


def test_suffix_array_method_sharded():
    """``suffix_array(codes, "sharded", device="cpu")``: one CPU shard (the
    default mesh), the same array as tpufm's ``method="sharded"``."""
    codes = _text("random", 3001)
    got = suffix_array(codes, "sharded", device="cpu")
    assert np.array_equal(got, jax_suffix_array(codes, method="sharded"))


def test_size_limit_is_int32(monkeypatch):
    """A text of n bases with n + 1 >= 2^31 is refused with the limit named,
    before anything is sorted (through the size check: no such text is
    made); n + 1 = 2^31 - 1 passes the check."""
    sa_sharded.check_size(2**31 - 2)
    with pytest.raises(ValueError, match=r"limit \(2147483646: n \+ 1 rows must stay below 2\^31"):
        sa_sharded.check_size(2**31 - 1)

    def sized(codes, mesh):  # a text that only claims its size
        sa_sharded.check_size(2**31)
        raise AssertionError("not refused")

    monkeypatch.setattr(sa_sharded, "text_lanes", sized)
    with pytest.raises(ValueError, match="exceeds the sharded suffix array limit"):
        sa_sharded.suffix_array_sharded_arr(np.zeros(5, np.uint8), make_mesh(2, device="cpu"))


@pytest.mark.parametrize("D,n", [(2, 100), (4, 3000), (8, 257)])
def test_round_collectives_closed_form(D, n):
    """Each round's collectives, as ``recording()`` logs them, are the
    closed form: the first round and doubling rounds at shifts below one
    shard, of whole shards, and of whole shards plus lanes."""
    codes = _text("repeat", n)
    mesh = make_mesh(D, device="cpu")
    big, m = n + 1, sa_sharded.shard_lanes(n, D)
    with coll.recording() as log:
        rank, _, _ = sa_sharded.initial(sa_sharded.text_lanes(codes, mesh), big)
    assert [(c.kind, c.shape, c.dtype, c.bytes) for c in log] == round_collectives(D, m)
    for h in (10, m, m + 3, 2 * m + 1):
        with coll.recording() as log:
            sa_sharded.step([r.clone() for r in rank], h, big)  # a round consumes its ranks
        assert [(c.kind, c.shape, c.dtype, c.bytes) for c in log] == round_collectives(D, m, h), h
    ops = round_collectives(4, 2_500_001, 10)
    assert len(ops) == 20 and sum(o[3] for o in ops) == 630_000_420  # PERF.md's closed form at 10 Mbase


def test_ppermute_pairs_and_ring():
    """``ppermute(xs, perm)``: JAX's semantics (a shard no pair reaches gets
    zeros), fresh tensors, the bytes of pairs between distinct shards; the
    ring form ``ppermute(xs, shift)`` is the pair list of the ring."""
    xs = [torch.arange(5, dtype=torch.int64) + 10 * s for s in range(4)]
    with coll.recording() as log:
        ring = coll.ppermute(xs, 1)
        pairs = coll.ppermute(xs, [(i, (i + 1) % 4) for i in range(4)])
        shift = coll.ppermute(xs, [(i, i + 1) for i in range(3)])
        swap = coll.ppermute(xs, [(0, 1), (1, 0), (2, 2)])
    for s in range(4):
        assert torch.equal(ring[s], xs[(s - 1) % 4]) and torch.equal(pairs[s], ring[s])
    assert torch.equal(shift[0], torch.zeros(5, dtype=torch.int64)) and torch.equal(shift[2], xs[1])
    assert torch.equal(swap[0], xs[1]) and torch.equal(swap[2], xs[2]) and not swap[3].any()
    swap[2].zero_()
    assert xs[2].any()  # a copy, also where a shard sends to itself
    assert [c.bytes for c in log] == [4 * 40, 4 * 40, 3 * 40, 2 * 40]
    with pytest.raises(ValueError, match="not a partial permutation"):
        coll.ppermute(xs, [(0, 1), (2, 1)])
