"""Collective-traffic model of the mesh engines, checked against the ops a
search really makes.

``collective_bytes_model`` is tpufm/parallel/traffic.py:22-61, copied: per
LF round, the bytes a shard sends and receives and the rank lookups it
answers, by routing (docs/DISTRIBUTED.md "Traffic model"). Request rows are
12 B per interval end (block, code, interval: three uint32), answers 4 B; B
is interval ends per shard (2 x the per-shard read part), D the mesh size.

``assert_collective_model`` is the counterpart of tpufm's (:80), which
parses the compiled HLO; the port compiles nothing, so it runs one wave of
the engine's search with the collectives log on
(tpufm_torch.parallel.collectives) and checks each logged op's kind and
per-shard shape, round by round, against the routing's plan:
- every engine: one exit merge, int32 [B_total, 2] (8 B a read), last;
- "dp": nothing else;
- "allgather": each round an all-gather [D, B, 3] and an all-reduce [D, B];
- "ring": each round 2D hops, each a collective-permute of a half-block of
  requests [B/2, 3] and of its answers [B/2], and never the full request set;
- "a2a": each round a pmax of the bucket maxima, then the two all-to-alls
  [D, C, 3] and [D, C] with C = ceil(2B / D), or, on a round the search
  reports as overflowing, the allgather round.
A mesh of one shard logs no collectives, and the check requires that.

``wave_bytes`` is the closed form of the bytes such a wave logs, worked out
from the same plan, summed over the mesh and split into bytes between
shards of one process and bytes across processes (a mesh of P processes
owning L shards each; the log's ``cross``), and the check holds the log to
it as well. The log is the same on every process, and so is the check.
"""

from __future__ import annotations

import math


def collective_bytes_model(routing: str, n_devices: int,
                           ends_per_chip: int) -> dict:
    """Per-LF-round collective payload bytes per chip, by routing
    (docs/DISTRIBUTED.md). Returns {"sent": ..., "received": ...,
    "answered_rows": ...} — `sent` counts bytes leaving the chip per
    round (the ICI budget), `answered_rows` the rank lookups the chip
    must compute (the D-fold compute overhead allgather/ring pay and
    a2a avoids)."""
    D, B = n_devices, ends_per_chip
    if routing == "allgather":
        # all-gather materializes the full [D, B, 3] request set on every
        # chip (each chip contributes its [B, 3] slice to D-1 peers), and
        # the [D, B] answers psum back.
        return {
            "sent": 12 * B * (D - 1) + 4 * B * (D - 1),
            "received": 12 * B * (D - 1) + 4 * B * (D - 1),
            "answered_rows": D * B,
        }
    if routing == "ring":
        # two half-blocks of B/2 requests circulate D hops each (one hop
        # per tick, phase-shifted so answering overlaps transit), plus the
        # accumulated 4 B answers riding every hop.
        return {
            "sent": (12 + 4) * (B // 2) * 2 * D,
            "received": (12 + 4) * (B // 2) * 2 * D,
            "answered_rows": D * B,
        }
    if routing == "a2a":
        # bucketed all-to-all at fixed capacity C = ceil(slack * B / D) per
        # destination (search.py _sharded_lf_step_a2a rounds UP so capacity
        # never truncates): C rows of 12 B out, C answers of 4 B back,
        # to/from each of D peers (self-bucket included in the op's shape).
        C = max(1, -(-2 * B // D))
        return {
            "sent": (12 + 4) * C * D,
            "received": (12 + 4) * C * D,
            "answered_rows": 2 * B,
        }
    raise ValueError(f"unknown routing {routing!r}")


def _round_plan(routing: str, D: int, B: int, overflow: bool) -> list:
    """[(kind, shape, itemsize, why)] of one LF round's collectives, in
    order: the logged result shape and its element size."""
    allgather = [("all-gather", (D, B, 3), 4, f"request circulation, 12*{B}*{D} B materialized/chip/round"),
                 ("all-reduce", (D, B), 4, f"answer psum, 4*{B}*{D} B/chip/round")]
    if routing == "allgather":
        return allgather
    if routing == "ring":
        half = (B + 1) // 2
        hop = [("collective-permute", (half, 3), 4, "half-block request hop, 12 B/end"),
               ("collective-permute", (half,), 4, "half-block answer hop, 4 B/end")]
        return hop * (2 * D)
    C = max(1, -(-2 * B // D))
    pmax = [("all-reduce", (), 8, "bucket overflow predicate (pmax)")]
    if overflow:
        return pmax + allgather
    return pmax + [("all-to-all", (D, C, 3), 4, f"bucketed requests, capacity C={C} rows x 12 B per peer"),
                   ("all-to-all", (D, C), 4, "bucketed answers, 4 B/row")]


def _wave_plan(routing: str, D: int, B_total: int, overflow=()) -> list:
    """The plan of one wave: each round's (``overflow`` one flag a k-step
    round; none for "dp"), then the merge of the result onto one shard."""
    B = 2 * (B_total // D)  # interval ends per shard
    plan = [] if routing == "dp" else [op for ov in overflow for op in _round_plan(routing, D, B, bool(ov))]
    return plan + [("gather", (B_total, 2), 4, "result merge, 8 B/read")]


def _op_bytes(kind: str, shape: tuple, itemsize: int, D: int, L: int) -> tuple:
    """(bytes, cross) that ``recording()`` logs for one op of the plan, from
    its result shape, on D shards, L a process: an all-gather (its input one
    row of the result) or an all-reduce moves every shard's tensor to each
    of the D - 1 others, D - L of them in other processes; an all-to-all, or
    the merge of each shard's 1/D of the result, each of the D - 1 parts a
    shard does not keep; a ring hop every shard's tensor to its neighbour,
    across processes on the ring's edges between two processes."""
    n = itemsize * math.prod(shape[1:] if kind == "all-gather" else shape)
    if kind == "collective-permute":
        return D * n, n * sum(i // L != (i + 1) % D // L for i in range(D))
    if kind in ("all-gather", "all-reduce"):
        return D * (D - 1) * n, D * (D - L) * n
    if kind == "gather":
        n //= D
    return (D - 1) * n, (D - L) * n


def wave_bytes(routing: str, D: int, B_total: int, overflow=(), L: int | None = None) -> dict:
    """The bytes one wave of B_total reads logs on D shards, L a process
    (default D: one process), by routing ("dp" the data-parallel engine),
    ``overflow`` its per-round a2a flags: the sum of ``_op_bytes`` over the
    wave's plan, {"bytes": between distinct shards, "across": between
    shards of different processes, "within": the rest}."""
    L = D if L is None else L
    total = cross = 0
    for kind, shape, itemsize, _ in (_wave_plan(routing, D, B_total, overflow) if D > 1 else ()):
        b, c = _op_bytes(kind, shape, itemsize, D, L)
        total, cross = total + b, cross + c
    return {"bytes": total, "across": cross, "within": total - cross}


def check_collective_log(log: list, routing: str, D: int, B_total: int, overflow=(), L: int | None = None) -> dict:
    """Hold ``log`` (``Collective``s of one search of B_total reads on D
    shards, L a process, ``overflow`` its per-round a2a flags, one per
    k-step round for a sharded engine) to the routing's plan, op by op
    (kind, shape and element size), and to ``wave_bytes``; raise
    AssertionError naming the first op missing or out of place, beside what
    was logged."""
    got = [(c.kind, c.shape, c.dtype.itemsize) for c in log]
    B = 2 * (B_total // D)  # interval ends per shard
    model = (collective_bytes_model(routing, D, B) if routing != "dp" else {"sent": 0, "received": 0})
    if D == 1:
        assert not got, f"a mesh of one shard logged collectives: {got}"
        return {"model": model, "shapes": got}
    plan = _wave_plan(routing, D, B_total, overflow)
    for i, (kind, shape, itemsize, why) in enumerate(plan):
        assert i < len(got) and got[i] == (kind, shape, itemsize), (
            f"routing={routing}: expected collective `{kind} {list(shape)}` of {itemsize} B elements ({why}) as "
            f"op {i}, found {got[i] if i < len(got) else 'nothing'}; logged collectives: {got}"
        )
    assert len(got) == len(plan), (
        f"routing={routing}: {len(got) - len(plan)} collectives past the plan; logged: {got[len(plan):]}"
    )
    if routing == "ring":
        assert not any(k == "all-gather" for k, _, _ in got), "ring routing must not materialize the full request set"
    want = wave_bytes(routing, D, B_total, overflow, L)
    logged = {"bytes": sum(c.bytes for c in log), "across": sum(c.cross for c in log)}
    logged["within"] = logged["bytes"] - logged["across"]
    assert logged == want, f"routing={routing}: logged bytes {logged}, closed form {want}"
    return {"model": model, "shapes": [g[:2] for g in got], **logged}


def assert_collective_model(eng, queries) -> dict:
    """Run one wave of ``eng``'s search on ``queries`` (a host batch [B_total,
    L], B_total a mesh multiple, or the per-shard parts ``shard_queries`` /
    ``place_queries`` give) with the collectives log on, and hold the log to
    the model (``check_collective_log``); across processes every process
    runs it on the same batch. Returns {"model": ..., "shapes": [...],
    "bytes": ..., "within": ..., "across": ...} for the caller to log."""
    from tpufm_torch.parallel import collectives as coll

    D = eng.mesh.size
    routing = getattr(eng, "routing", "dp")
    if not isinstance(queries, (list, tuple)):
        queries = eng.place_queries(queries) if routing != "dp" else eng.shard_queries(queries)
    B_total = sum(q.shape[0] for q in queries) * eng.mesh.process_count
    with coll.recording() as log:
        out = eng.search_device(list(queries))
    overflow = () if routing == "dp" else out[1]
    return check_collective_log(log, routing, D, B_total, overflow, eng.mesh.local_count)
