"""The port's mesh engines (tpufm_torch.parallel) on CPU shards against
tpufm's on its virtual CPU devices (tests/conftest.py: 8), at small sizes:
``DataParallelEngine`` and ``ShardedIndexEngine`` (allgather, ring, a2a)
over meshes of 4 and 8, the a2a fallback flags round by round, the split of
the entry table (``shard_tables`` against ``shards_from_jax``), the traffic
model and its check, K9's plain version against tpufm's ``_answer_owned``
under ``shard_map``, the collectives and the mesh. The cases mirror
tests/test_parallel.py. Inputs come from numpy seeds; intervals, counts and
flags are integers and compare exactly (tolerance 0)."""

import datetime
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufm.config import IndexConfig as JaxConfig
from tpufm.engine.oracle import search_oracle
from tpufm.index.builder import build_index as jax_build_index
from tpufm.index.layouts import make_alt_counters as jax_make_alt_counters
from tpufm.parallel import DataParallelEngine as JaxDP
from tpufm.parallel import ShardedIndexEngine as JaxSharded
from tpufm.parallel import make_mesh as jax_make_mesh
from tpufm_torch.engine import lf_round as lf_mod
from tpufm_torch.engine.search import pad_cycle, stream_waves
from tpufm_torch.engine.tables import shard_tables, shards_from_jax
from tpufm_torch.host.index import IndexConfig, build_index, derive_tail
from tpufm_torch.host.layouts import make_alt_counters
from tpufm_torch.parallel import (
    DataParallelEngine,
    Mesh,
    ShardedIndexEngine,
    assert_collective_model,
    collective_bytes_model,
    initialize_distributed,
    make_mesh,
    shutdown_distributed,
)
from tpufm_torch.parallel import collectives as coll
from tpufm_torch.parallel import traffic

ROUTINGS = ["allgather", "ring", "a2a"]


@functools.lru_cache(maxsize=None)
def _case(k, d, n, seed=5):
    """(text, tpufm's index, the port's index) of a seeded random text."""
    codes = np.random.default_rng(seed).integers(0, 4, size=n, dtype=np.uint8)
    return codes, jax_build_index(codes, JaxConfig(k=k, d=d), sa_method="doubling"), build_index(
        codes, IndexConfig(k=k, d=d))


def _reads(codes, L, n, random=0, seed=1):
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(codes) - L, size=n)
    q = codes[starts[:, None] + np.arange(L)]
    return np.concatenate([q, rng.integers(0, 4, size=(random, L), dtype=np.uint8)])


def _cpu(D):
    return make_mesh(D, device="cpu")


@pytest.mark.parametrize("D", [4, 8])
@pytest.mark.parametrize("k,d", [(1, 64), (2, 64), (3, 64)])
def test_data_parallel_matches_tpufm(k, d, D):
    codes, jidx, tidx = _case(k, d, 4096)
    q = _reads(codes, 12 * k, 56, random=8)
    want = JaxDP(jidx, jax_make_mesh(D)).search(q)
    np.testing.assert_array_equal(want, search_oracle(jidx, q))
    np.testing.assert_array_equal(DataParallelEngine(tidx, _cpu(D)).search(q), want)


@pytest.mark.parametrize("D", [4, 8])
def test_data_parallel_alt_counters_lut_and_ragged(D):
    codes, jidx, tidx = _case(2, 64, 4096)
    q = _reads(codes, 24, 30)  # 30 reads: padded by cycling on both meshes
    ac = DataParallelEngine(make_alt_counters(tidx), _cpu(D))
    np.testing.assert_array_equal(ac.search(q), JaxDP(jax_make_alt_counters(jidx), jax_make_mesh(D)).search(q))
    lut = DataParallelEngine(tidx, _cpu(D), lut_m=4)
    np.testing.assert_array_equal(lut.search(q), JaxDP(jidx, jax_make_mesh(D), lut_m=4).search(q))
    np.testing.assert_array_equal(lut.search(q), search_oracle(jidx, q))
    with pytest.raises(ValueError, match="batch 30 not divisible by mesh size"):
        lut.shard_queries(q)


def test_data_parallel_varlen_tail_and_count():
    codes, jidx, tidx = _case(3, 64, 6000)
    jtail = jax_build_index(codes, JaxConfig(k=1, d=64), sa_method="doubling")
    q = _reads(codes, 30, 43)
    q[::3, :7] = 0xFF  # 23 bp reads, right-aligned, among 30 bp ones
    mesh = jax_make_mesh(4)
    jdp = JaxDP(jidx, mesh, lut_m=6, tail_index=jtail)
    tdp = DataParallelEngine(tidx, _cpu(4), lut_m=6, tail_index=derive_tail(tidx))
    np.testing.assert_array_equal(tdp.search_varlen(q), jdp.search_varlen(q))
    full = _reads(codes, 31, 21, random=5)  # 31 % 3: one tail round
    np.testing.assert_array_equal(tdp.search(full), jdp.search(full))
    for m in (0, 1):
        np.testing.assert_array_equal(tdp.count(full, mismatches=m), jdp.count(full, mismatches=m))


def _refusal(fn):
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return type(e).__name__, str(e)
    return None


def test_data_parallel_refusals_word_for_word():
    codes, jidx, tidx = _case(2, 64, 4096)
    jm, tm = jax_make_mesh(4), _cpu(4)
    jtail1 = jax_build_index(codes, JaxConfig(k=2, d=64), sa_method="doubling")  # not k=1
    ttail1 = build_index(codes, IndexConfig(k=2, d=64))
    q = _reads(codes, 24, 8)
    cases = [
        (lambda: JaxDP(jax_make_alt_counters(jidx), jm, lut_m=4),
         lambda: DataParallelEngine(make_alt_counters(tidx), tm, lut_m=4)),
        (lambda: JaxDP(jidx, jm, lut_m=3), lambda: DataParallelEngine(tidx, tm, lut_m=3)),
        (lambda: JaxDP(jax_make_alt_counters(jidx), jm, tail_index=jtail1),
         lambda: DataParallelEngine(make_alt_counters(tidx), tm, tail_index=ttail1)),
        (lambda: JaxDP(jidx, jm, tail_index=jtail1), lambda: DataParallelEngine(tidx, tm, tail_index=ttail1)),
        (lambda: JaxDP(jidx, jm).search_varlen(q), lambda: DataParallelEngine(tidx, tm).search_varlen(q)),
        (lambda: JaxDP(jax_make_alt_counters(jidx), jm).search_varlen(q),
         lambda: DataParallelEngine(make_alt_counters(tidx), tm).search_varlen(q)),
        (lambda: JaxDP(jidx, jm).count(q, mismatches=2), lambda: DataParallelEngine(tidx, tm).count(q, mismatches=2)),
        (lambda: JaxDP(jax_make_alt_counters(jidx), jm).count(q, mismatches=1),
         lambda: DataParallelEngine(make_alt_counters(tidx), tm).count(q, mismatches=1)),
    ]
    for jax_fn, torch_fn in cases:
        want = _refusal(jax_fn)
        assert want is not None and _refusal(torch_fn) == want


@pytest.mark.parametrize("D", [4, 8])
@pytest.mark.parametrize("routing", ROUTINGS)
@pytest.mark.parametrize("k,d", [(1, 32), (2, 64)])
def test_sharded_index_matches_tpufm(k, d, routing, D):
    codes, jidx, tidx = _case(k, d, 8192)
    q = _reads(codes, 12 * k, 56, random=8)
    jeng = JaxSharded(jidx, jax_make_mesh(D), routing=routing)
    want = jeng.search(q)
    np.testing.assert_array_equal(want, search_oracle(jidx, q))
    teng = ShardedIndexEngine(tidx, _cpu(D), routing=routing)
    np.testing.assert_array_equal(teng.search(q), want)
    np.testing.assert_array_equal(teng.last_overflow_rounds, jeng.last_overflow_rounds)
    # the split itself, and an engine on tpufm's split
    ported = shards_from_jax(jeng)
    own = shard_tables(tidx, D)
    assert ported.e_local == own.e_local == teng.e_local
    for a, b in zip(ported.occ + ported.bitmaps, own.occ + own.bitmaps):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ported.dollar, own.dollar)
    np.testing.assert_array_equal(ShardedIndexEngine(ported, _cpu(D), routing=routing).search(q), want)


@pytest.mark.parametrize("routing", ROUTINGS)
def test_sharded_small_table_and_lut_waves(routing):
    codes, jidx, tidx = _case(2, 64, 200)  # 4 entries on 8 shards
    q = _reads(codes, 8, 32)
    np.testing.assert_array_equal(ShardedIndexEngine(tidx, _cpu(8), routing=routing).search(q),
                                  search_oracle(jidx, q))
    codes, jidx, tidx = _case(2, 64, 8192)
    q = _reads(codes, 24, 150, random=10)  # 160 reads: three waves of 64, the last padded
    jeng = JaxSharded(jidx, jax_make_mesh(8), routing=routing, lut_m=4)
    teng = ShardedIndexEngine(tidx, _cpu(8), routing=routing, lut_m=4)
    np.testing.assert_array_equal(teng.search(q, wave=64), jeng.search(q, wave=64))
    np.testing.assert_array_equal(teng.last_overflow_rounds, jeng.last_overflow_rounds)
    assert len(teng.last_overflow_waves) == 3
    ported = shards_from_jax(jeng)
    np.testing.assert_array_equal(ported.lut, teng.lut[0].numpy().view(np.uint32))
    np.testing.assert_array_equal(ShardedIndexEngine(ported, _cpu(8), routing=routing).search(q), search_oracle(
        jidx, q))


def test_sharded_ring_odd_local_batch_and_tail():
    codes, jidx, tidx = _case(2, 64, 4096)
    q = _reads(codes, 8, 24)  # 3 reads a shard
    np.testing.assert_array_equal(ShardedIndexEngine(tidx, _cpu(8), routing="ring").search(q),
                                  search_oracle(jidx, q))
    codes, jidx, tidx = _case(3, 64, 6000)
    jtail = jax_build_index(codes, JaxConfig(k=1, d=64), sa_method="doubling")
    q = _reads(codes, 26, 40)  # (26 - 6) % 3: two k=1 tail rounds after the LUT
    for routing in ROUTINGS:
        jeng = JaxSharded(jidx, jax_make_mesh(4), routing=routing, lut_m=6, tail_index=jtail)
        teng = ShardedIndexEngine(tidx, _cpu(4), routing=routing, lut_m=6, tail_index=derive_tail(tidx))
        np.testing.assert_array_equal(teng.search(q), jeng.search(q))
        ported = ShardedIndexEngine(shards_from_jax(jeng), _cpu(4), routing=routing)
        np.testing.assert_array_equal(ported.search(q), jeng.search(q))


def test_sharded_a2a_overflow_rounds_equal_tpufm():
    codes, jidx, tidx = _case(2, 64, 4096)
    same = np.repeat(codes[100:124][None, :], 64, axis=0)  # every request in one bucket
    rand = _reads(codes, 24, 256, seed=3)  # no LUT: the early rounds are skewed
    jeng = JaxSharded(jidx, jax_make_mesh(8), routing="a2a")
    teng = ShardedIndexEngine(tidx, _cpu(8), routing="a2a")
    for q in (same, rand):
        np.testing.assert_array_equal(teng.search(q), jeng.search(q))
        np.testing.assert_array_equal(teng.last_overflow_rounds, jeng.last_overflow_rounds)
    assert teng.last_overflow_rounds.any() and not teng.last_overflow_rounds.all()
    np.testing.assert_array_equal(teng.search(same), search_oracle(jidx, same))
    assert teng.last_overflow_rounds.all()


@pytest.mark.parametrize("routing", ROUTINGS)
def test_sharded_owner_answers_go_through_k9(monkeypatch, routing):
    """Every owner answer is one call of K9's wrapper: D a round for
    allgather and a2a, an overflowing a2a round (which takes the allgather
    step) included, 2D a shard a round for the ring; a ``step`` is refused."""
    import tpufm_torch.parallel.search as psearch

    codes, jidx, tidx = _case(2, 64, 4096)
    calls = []
    real = psearch.lf_answer_owned
    monkeypatch.setattr(psearch, "lf_answer_owned", lambda *a: calls.append(a[3]) or real(*a))
    eng = ShardedIndexEngine(tidx, _cpu(4), routing=routing)
    per_round = {"allgather": 4, "ring": 2 * 4 * 4, "a2a": 4}[routing]
    same = np.repeat(codes[100:124][None, :], 64, axis=0)  # a2a: every request in one bucket
    for q in (same, _reads(codes, 24, 64, seed=3)):
        calls.clear()
        np.testing.assert_array_equal(eng.search(q), search_oracle(jidx, q))
        assert len(calls) == per_round * 12 and sorted(set(calls)) == [0, 1, 2, 3]
        if q is same:
            assert eng.last_overflow_rounds.any() == (routing == "a2a")
    with pytest.raises(ValueError, match="step must be None"):
        eng.search(same, step=lf_mod.lf_round_reference)


def test_sharded_tiny_lut_wave_too_small_and_refusals():
    codes, jidx, tidx = _case(1, 32, 2048)
    q = _reads(codes, 8, 32)
    np.testing.assert_array_equal(ShardedIndexEngine(tidx, _cpu(8), routing="a2a", lut_m=1).search(q),
                                  search_oracle(jidx, q))
    codes, jidx, tidx = _case(2, 64, 512)
    jm, tm = jax_make_mesh(8), _cpu(8)
    zeros = np.zeros((64, 8), np.uint8)
    cases = [
        (lambda: JaxSharded(jidx, jm).search(zeros, wave=4), lambda: ShardedIndexEngine(tidx, tm).search(zeros, wave=4)),
        (lambda: JaxSharded(jax_make_alt_counters(jidx), jm),
         lambda: ShardedIndexEngine(make_alt_counters(tidx), tm)),
        (lambda: JaxSharded(jidx, jm, routing="mesh"), lambda: ShardedIndexEngine(tidx, tm, routing="mesh")),
        (lambda: JaxSharded(jidx, jm, lut_m=3), lambda: ShardedIndexEngine(tidx, tm, lut_m=3)),
        (lambda: JaxSharded(jidx, jm).search(np.zeros((64, 9), np.uint8)),
         lambda: ShardedIndexEngine(tidx, tm).search(np.zeros((64, 9), np.uint8))),
    ]
    for jax_fn, torch_fn in cases:
        want = _refusal(jax_fn)
        assert want is not None and _refusal(torch_fn) == want


def test_sharded_tables_on_a_device_split_where_they_lie():
    """An index whose tables are tensors (``build_index_device(return_host=
    False)``) is padded and cut as tensors, equal to the host split."""
    from tpufm_torch.index.builder_device import build_index_device

    codes, jidx, tidx = _case(2, 64, 5000)
    dev_index = build_index_device(codes, IndexConfig(k=2, d=64), return_host=False, device="cpu")
    split = shard_tables(dev_index, 3)
    assert isinstance(split.occ[0], torch.Tensor)
    for a, b in zip(split.occ + split.bitmaps, shard_tables(tidx, 3).occ + shard_tables(tidx, 3).bitmaps):
        np.testing.assert_array_equal(a.numpy().view(np.uint32), b)
    q = _reads(codes, 24, 30)
    np.testing.assert_array_equal(ShardedIndexEngine(dev_index, _cpu(3), routing="a2a", lut_m=4).search(q),
                                  search_oracle(jidx, q))


@pytest.mark.parametrize("D", [1, 2, 4, 8])
@pytest.mark.parametrize("routing", ROUTINGS)
def test_collective_bytes_model_matches_tpufm(routing, D):
    from tpufm.parallel import collective_bytes_model as jax_model

    for B in (2, 64, 130, 1040):
        assert collective_bytes_model(routing, D, B) == jax_model(routing, D, B)
    with pytest.raises(ValueError, match="unknown routing"):
        collective_bytes_model("mesh", D, 64)


@pytest.mark.parametrize("reads", [512, 520])
@pytest.mark.parametrize("routing", ROUTINGS)
def test_collective_traffic_model(routing, reads):
    """One wave's collectives are the routing's plan (12 B/end requests, 4 B
    answers, the 8 B/read exit merge), with tpufm's byte model: a 520-read
    batch on 8 shards rounds the a2a capacity up (C = 33, not 32)."""
    codes, jidx, tidx = _case(2, 64, 40000)
    from tpufm.io.genreads import generate_reads

    q = generate_reads(codes, 24, reads, seed=1)
    eng = ShardedIndexEngine(tidx, _cpu(8), routing=routing)
    r = assert_collective_model(eng, q)
    D, B = 8, 2 * (reads // 8)
    model = r["model"]
    if routing == "allgather":
        assert model["sent"] == 16 * B * (D - 1) and model["answered_rows"] == D * B
        assert ("all-gather", (D, B, 3)) in r["shapes"] and ("all-reduce", (D, B)) in r["shapes"]
    elif routing == "ring":
        assert model["sent"] == 16 * B * D
        assert ("collective-permute", (B // 2, 3)) in r["shapes"]
    else:
        C = -(-2 * B // D)
        assert model["sent"] == 16 * C * D and model["answered_rows"] == 2 * B
        assert ("all-to-all", (D, C, 3)) in r["shapes"] and ("all-to-all", (D, C)) in r["shapes"]
    assert r["shapes"][-1] == ("gather", (reads, 2))


def test_collective_model_dp_and_mesh1():
    codes, jidx, tidx = _case(2, 64, 4096)
    q = _reads(codes, 24, 64)
    r = assert_collective_model(DataParallelEngine(tidx, _cpu(8)), q)
    assert r["shapes"] == [("gather", (64, 2))] and r["model"] == {"sent": 0, "received": 0}
    for eng in (DataParallelEngine(tidx, _cpu(1)), ShardedIndexEngine(tidx, _cpu(1), routing="a2a")):
        assert assert_collective_model(eng, q)["shapes"] == []


def test_collective_model_detects_missing_op():
    """The check fails when an expected collective is absent or extra (it
    must not degenerate into a no-op)."""
    codes, jidx, tidx = _case(2, 64, 4096)
    eng = ShardedIndexEngine(tidx, _cpu(4), routing="allgather")
    q = _reads(codes, 24, 64)
    with coll.recording() as log:
        _, overflow = eng.search_device(eng.place_queries(q))
    traffic.check_collective_log(log, "allgather", 4, 64, overflow)
    with pytest.raises(AssertionError, match="expected collective `all-reduce"):
        traffic.check_collective_log([c for c in log if c.kind != "all-reduce"], "allgather", 4, 64, overflow)
    with pytest.raises(AssertionError, match="past the plan"):
        traffic.check_collective_log(log + log[-1:], "allgather", 4, 64, overflow)
    with pytest.raises(AssertionError, match="one shard logged"):
        traffic.check_collective_log(log, "allgather", 1, 64, overflow)


@pytest.mark.parametrize("D", [3, 4, 8])
@pytest.mark.parametrize("k,d", [(1, 32), (2, 64), (3, 96)])
def test_answer_owned_plain_matches_tpufm_under_shard_map(k, d, D):
    """K9's plain version on every shard against tpufm's ``_answer_owned``
    run by ``shard_map`` on D devices, on chip_smoke phase 19(e)'s edge-case
    requests (zero rows, '$' blocks, shard edges, padded rows, owners past
    the mesh)."""
    import chip_smoke
    from jax.sharding import PartitionSpec as P
    from tpufm.parallel.search import _answer_owned, _shard_map

    codes, jidx, tidx = _case(k, d, 7000)
    jeng = JaxSharded(jidx, jax_make_mesh(D))
    split = shard_tables(tidx, D)
    dollar = np.stack([tidx.dollar_pos, tidx.dollar_base, tidx.dollar_block]).astype(np.int64)
    req = chip_smoke.k9_edge_requests(np.random.default_rng(k + D), tidx.bwtsize, k, d, dollar, D,
                                      split.e_local, 1000)
    cfg = (k, d, d // 32, split.e_local)
    axis = jeng.axis

    def answer(occ, bitmaps, dpos, dbase, dblock, r):
        me = jax.lax.axis_index(axis).astype(jnp.uint32)
        return _answer_owned(occ, bitmaps, (dpos, dbase, dblock), cfg, me, r[:, 0], r[:, 1], r[:, 2])[None]

    fn = jax.jit(_shard_map()(answer, mesh=jeng.mesh, in_specs=(P(axis), P(axis), P(), P(), P(), P()),
                              out_specs=P(axis)))
    want = np.asarray(fn(jeng.occ, jeng.bitmaps, *jeng.dollar, jnp.asarray(req.view(np.uint32))))
    dol = torch.from_numpy(dollar)
    for s in range(D):
        got = lf_mod.lf_answer_owned(torch.from_numpy(split.bitmaps[s].view(np.int32)),
                                     torch.from_numpy(split.occ[s].view(np.int32)), torch.from_numpy(req), s,
                                     split.e_local, dol, k, d)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want[s])


@pytest.mark.parametrize("routing", ROUTINGS)
def test_k9_request_streams_at_the_timed_shapes(routing):
    """The request streams ``chip_smoke.capture_requests`` keeps, on a CPU
    mesh of D = 4 at the engine's wave (WAVE_PER_CHIP = 2^17 reads a shard,
    B = 2^18 ends), are the shapes K9 is designed and timed for
    (scripts/k89_ab.py): allgather D x B = 2^20 rows, each shard owning
    about 1/D of them after the LUT start; the ring's half-blocks of B / 2 =
    2^17 rows, 2D a shard a round, about 1/D owned; a2a's D x C = 2^19
    rows (C = 2B / D), about half owned. The first reads' intervals equal
    the oracle's."""
    import chip_smoke

    D, wave = 4, ShardedIndexEngine.WAVE_PER_CHIP
    codes, jidx, tidx = _case(1, 32, 8192)
    eng = ShardedIndexEngine(tidx, _cpu(D), routing=routing, lut_m=4)
    q = _reads(codes, 6, D * wave, seed=7)  # two rounds after the 4-mer LUT
    per_round = 2 * D if routing == "ring" else 1
    (iv, _), kept = chip_smoke.capture_requests(eng, eng.place_queries(q), (1, per_round + 1))
    np.testing.assert_array_equal(iv[:512].numpy().astype(np.uint32), search_oracle(jidx, q[:512]))
    rows = {"allgather": D * 2 * wave, "ring": wave, "a2a": D * (2 * 2 * wave // D)}[routing]
    # a2a: bucket j holds the about B / D requests of j, then the next buckets' (owned elsewhere)
    owned = {"allgather": 1 / D, "ring": 1 / D, "a2a": 1 / 2}[routing]
    assert sorted(kept) == [(j, s) for j in (1, per_round + 1) for s in range(D)]
    for (j, s), req in kept.items():
        assert req.dtype == torch.int32 and tuple(req.shape) == (rows, 3), (j, s)
        share = float((req[:, 0].to(torch.int64) // eng.e_local == s).double().mean())
        assert abs(share - owned) < 0.05, (j, s, share)


def test_collectives_semantics_and_no_aliasing():
    xs = [torch.arange(6, dtype=torch.int32).reshape(2, 3) + 10 * s for s in range(4)]
    with coll.recording() as log:
        g = coll.all_gather(xs)
        p = coll.psum(xs)
        m = coll.pmax(xs)
        r = coll.ppermute(xs)
        a = coll.all_to_all([torch.stack([x[0]] * 4) + s for s, x in enumerate(xs)])
        out = coll.gather(xs)
    for s in range(4):
        assert torch.equal(g[s], torch.stack(xs))
        assert torch.equal(p[s], sum(xs)) and p[s].dtype == torch.int32
        assert torch.equal(m[s], xs[3])
        assert torch.equal(r[s], xs[(s - 1) % 4])
        for j in range(4):
            assert torch.equal(a[s][j], xs[j][0] + j)
    assert torch.equal(out, torch.cat(xs))
    # every result is a new tensor: writing one shard's copy reaches no other
    r[1].zero_()
    assert xs[0].sum() != 0 and not torch.equal(r[1], r[2])
    assert [c.kind for c in log] == ["all-gather", "all-reduce", "all-reduce", "collective-permute",
                                     "all-to-all", "gather"]
    assert log[0].shape == (4, 2, 3) and log[0].bytes == 4 * 3 * 24 and log[-1].bytes == 3 * 24
    with coll.recording() as log1:
        coll.all_gather(xs[:1])
    assert log1 == []


def test_mesh_pad_cycle_and_stream_waves(monkeypatch):
    from tpufm.utils.waves import pad_cycle as jax_pad_cycle

    rows = np.arange(15, dtype=np.uint8).reshape(5, 3)
    for pad in (0, 2, 5, 13):
        np.testing.assert_array_equal(pad_cycle(rows, pad), jax_pad_cycle(rows, pad))
    for device, last in ((None, [8, 9, 8, 9]), (torch.device("cpu"), [8, 9])):
        seen = []
        out = stream_waves(np.arange(10, dtype=np.uint8)[:, None], 4,
                           lambda c: seen.append(np.asarray(c).copy()) or torch.as_tensor(c).to(torch.int64), device,
                           (1,))
        np.testing.assert_array_equal(out[:, 0], np.arange(10))
        # a mesh engine's last wave (device None) is padded with its own rows; a device's stays short
        np.testing.assert_array_equal(seen[-1][:, 0], last)
    assert make_mesh(3, device="cpu").size == 3 and make_mesh(device="cpu").size == 1
    assert Mesh([torch.device("cpu")] * 2, "x").axis_names == ("x",)
    # initialize_distributed's refusals, before it joins any group: no
    # coordinator and no torchrun environment; NCCL with two ranks on one card
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="no coordinator given and no torchrun environment"):
        initialize_distributed()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"backend='nccl' puts 2 ranks on this host's 1 card\(s\): NCCL refuses"):
        initialize_distributed("127.0.0.1:1", num_processes=2, process_id=0, backend="nccl")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="NCCL refuses two ranks on one card"):
        initialize_distributed(backend="nccl")
    # NCCL where every rank would take every card: a host of unknown ranks
    # (a coordinator off this host) or of two ranks with two cards; none of
    # these reaches the group
    monkeypatch.setattr(torch.distributed, "init_process_group", lambda **kw: bound.append(kw))
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: bound.append(i))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    bound = []
    for coordinator in ("coordinator.invalid:1", "127.0.0.1:1"):
        with pytest.raises(ValueError, match="backend='nccl' with no local_device_ids and no LOCAL_RANK"):
            initialize_distributed(coordinator, num_processes=2, process_id=0, backend="nccl")
    assert bound == []
    # a named card binds the process to it before the group forms
    initialize_distributed("coordinator.invalid:1", num_processes=2, process_id=1, local_device_ids=[1],
                           backend="nccl")
    assert bound == [1, {"backend": "nccl", "init_method": "tcp://coordinator.invalid:1", "world_size": 2,
                         "rank": 1, "timeout": datetime.timedelta(seconds=300)}]
    shutdown_distributed()
    assert not torch.distributed.is_initialized()


def test_make_mesh_needs_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="^need 2 devices, have 1$"):
        make_mesh(2)
    assert [str(d) for d in make_mesh(1).devices] == ["cuda:0"]
    with pytest.raises(ValueError) as jax_err:
        jax_make_mesh(len(jax.devices()) + 1)
    assert str(jax_err.value) == f"need {len(jax.devices()) + 1} devices, have {len(jax.devices())}"
