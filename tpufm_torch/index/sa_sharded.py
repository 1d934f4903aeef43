"""Suffix array of a text sorted over a mesh of shards: prefix doubling.

Counterpart of tpufm/index/sa_sharded.py (``make_global_sort`` :61,
``_programs`` :112 with ``boundary_prev`` :130, ``global_rank_from_sorted``
:137, ``restore_index_order`` :157, ``initial_fn`` :165 and ``step_fn``
:183; ``suffix_array_sharded_arr`` :229, ``suffix_array_sharded`` :265).
Every array of the sort is a list of one tensor a shard, shard s holding
global lanes s*m .. (s+1)*m - 1 on ``mesh.devices[s]``, with ``m =
max(ceil((n + 1) / D), PACK)`` (the neighbour fetch of the first key reads
PACK lanes of the next shard). Lanes at or past n + 1 are pads. The
collectives are tpufm_torch.parallel.collectives'. Every function takes
the ``mesh`` the lists live on; None is one process owning every shard of
the list. Across processes (a mesh of ``initialize_distributed``) each
list holds the shards this process owns, shard ids stay global, and the
pairs of a merge-split may lie in two processes: each sorts the same
concatenation, lower shard first, as in one process.

- The global sort is a ``torch.sort`` a shard, then D rounds of odd-even
  block transposition: in round r the shards (i, i + 1), i = r % 2, 2 + r %
  2, ..., swap their blocks by ``ppermute`` and both sort the pair's two
  blocks, lower shard's first, each keeping its half. With sorted blocks
  this sorts any keys in D rounds (the 0-1 principle on the block network).
- Ranks come from the sorted keys: the flags of key changes (the previous
  shard's last key fetched by a one-lane ``ppermute``), a cumulative sum a
  shard plus the ``all_gather`` of the shard totals, and a ``psum`` of the
  changes on real lanes for the distinct test, one scalar the host reads a
  round (the early exit).
- A second global sort, by lane index, brings the ranks back to index
  order.
- The first key packs PACK symbols (symbol + 1, 3 bits each) as the
  one-device sort's; a doubling round at shift h = q*m + r reads rank[i + h]
  from the shards q and q + 1 further on (two ``ppermute`` of whole shards)
  and sorts ``rank << 32 | second``.

The key. tpufm sorts uint32 triples (rank, second, index), so that every
key is unique and pads carry 0xFFFFFFFF. Here a lane's key is one int64,
``rank << 32 | second`` (the first round: the packed symbols), and its
lane index rides along: ranks and seconds are below n + 1 < 2^31, and a
pad's key is the int64 maximum, above every real key. Keys of two lanes may
tie, and the ranks do not depend on how ties are ordered (they count key
changes); once every key is distinct, the order is the unique suffix array.
Tied keys do make one demand of the merge-split: both shards of a pair must
see one merged order, or a lane tied across the split could be kept by both
or by neither. So each shard of a pair sorts the same concatenation (the
lower shard's block first) with a stable sort. The limit is the one-device
sort's: n + 1 < 2^31 (``check_size``), the int32 range of ranks and rows.
"""

from __future__ import annotations

import numpy as np
import torch

from tpufm_torch.index.sa_device import PACK
from tpufm_torch.parallel import collectives as coll

#: the largest text the sharded sort takes: ranks, rows and the suffix
#: array are int32 and a key packs rank and second into 31 bits each
MAX_SHARDED_BASES = 2**31 - 2

#: the key of a pad lane, above every real key
PAD_KEY = torch.iinfo(torch.int64).max


def check_size(n: int) -> None:
    """Raise for a text of ``n`` bases whose n + 1 rows pass the int32 range."""
    if n > MAX_SHARDED_BASES:
        raise ValueError(
            f"text of {n} bases exceeds the sharded suffix array limit ({MAX_SHARDED_BASES}: n + 1 "
            "rows must stay below 2^31, the int32 range of its ranks and rows)"
        )


def shard_lanes(n: int, D: int) -> int:
    """The lanes a shard holds for a text of ``n`` bases on ``D`` shards."""
    return max(-(-(n + 1) // D), PACK)


def _shards(xs: list, mesh) -> tuple:
    """(D, the global shard of each entry of ``xs``)."""
    if mesh is None:
        return len(xs), tuple(range(len(xs)))
    return mesh.size, mesh.local_shards


def lane_index(xs: list, mesh=None) -> list:
    """Each shard's global lane numbers, int32 [m]."""
    m = xs[0].shape[0]
    return [torch.arange(s * m, (s + 1) * m, dtype=torch.int32, device=x.device)
            for s, x in zip(_shards(xs, mesh)[1], xs)]


def global_sort(keys: list, payload: list, mesh=None) -> tuple:
    """Sort (key, payload) lanes over the mesh by key: shard s ends with the
    s-th block of m lanes in key order (tpufm's ``make_global_sort``). The
    two lists are sorted in place, each tensor replaced as its shard
    moves on (so that the unsorted ones are freed), and returned."""
    (D, ids), m = _shards(keys, mesh), keys[0].shape[0]
    at = {s: i for i, s in enumerate(ids)}
    for i in range(len(keys)):
        keys[i], order = torch.sort(keys[i])
        payload[i] = payload[i][order]
    for r in range(D):
        pairs = [(a, a + 1) for a in range(r % 2, D - 1, 2)]
        if not pairs:
            continue
        perm = [(a, b) for a, b in pairs] + [(b, a) for a, b in pairs]
        got_k, got_p = coll.ppermute(keys, perm, mesh), coll.ppermute(payload, perm, mesh)
        for a, b in pairs:
            for s, half in ((a, slice(0, m)), (b, slice(m, 2 * m))):
                if s not in at:  # another process's shard
                    continue
                i = at[s]
                both_k = torch.cat([keys[i], got_k[i]] if s == a else [got_k[i], keys[i]])
                both_p = torch.cat([payload[i], got_p[i]] if s == a else [got_p[i], payload[i]])
                merged, order = torch.sort(both_k, stable=True)
                keys[i], payload[i] = merged[half].clone(), both_p[order[half]]
    return keys, payload


def boundary_prev(keys: list, mesh=None) -> list:
    """Each shard's previous global key (the last of the shard before it;
    shard 0 gets 0), int64 [1]."""
    D = _shards(keys, mesh)[0]
    return coll.ppermute([k[-1:] for k in keys], [(i, i + 1) for i in range(D - 1)], mesh)


def global_rank_from_sorted(keys: list, idx: list, big: int, mesh=None) -> tuple:
    """Sorted keys and their lanes -> (the global rank of each sorted lane,
    int32 [m] a shard; whether the real lanes' keys are all distinct, a 0-d
    bool tensor on the first shard's device, the same in every process)."""
    ids = _shards(keys, mesh)[1]
    changed = []
    for s, k, prev in zip(ids, keys, boundary_prev(keys, mesh)):
        c = torch.empty_like(k, dtype=torch.bool)
        c[1:] = k[1:] != k[:-1]
        c[:1] = (k[:1] != prev) if s else False
        changed.append(c)
    loc = [torch.cumsum(c, 0, dtype=torch.int32) for c in changed]
    totals = coll.all_gather([x[-1] for x in loc], mesh)
    ranks = [x + totals[i][:s].sum(dtype=torch.int32) for i, (s, x) in enumerate(zip(ids, loc))]
    real = coll.psum([(c & (i < big)).sum() for c, i in zip(changed, idx)], mesh)
    return ranks, real[0] + 1 == big


def restore_index_order(idx: list, rank_sorted: list, mesh=None) -> list:
    """Ranks of sorted lanes -> ranks in lane order (a second global sort,
    by lane index: shard s ends with lanes s*m .. (s+1)*m - 1). Consumes
    ``rank_sorted``; ``idx`` is left as it is."""
    _, ranks = global_sort(list(idx), rank_sorted, mesh)
    return ranks


def text_lanes(codes: np.ndarray, mesh) -> list:
    """A host text as the first key's lanes: symbol + 1 (int32), 0 at the
    sentinel and the pads, ``shard_lanes`` a shard, this process's shards
    each on its device."""
    n, D = codes.shape[0], mesh.size
    m = shard_lanes(n, D)
    c = np.zeros(D * m, np.int32)
    c[:n] = codes
    c[:n] += 1
    return [torch.from_numpy(c[s * m:(s + 1) * m]).to(dev) for s, dev in zip(mesh.local_shards, mesh.devices)]


def _round(keys: list, big: int, mesh) -> tuple:
    """Sort the lanes' keys (the list is consumed), rank them, and bring
    the ranks to lane order: (rank int32 [m], the sorted lanes int32 [m],
    distinct)."""
    sidx = lane_index(keys, mesh)
    for k, i in zip(keys, sidx):
        k.masked_fill_(i >= big, PAD_KEY)
    global_sort(keys, sidx, mesh)
    rank_sorted, distinct = global_rank_from_sorted(keys, sidx, big, mesh)
    keys.clear()
    return restore_index_order(sidx, rank_sorted, mesh), sidx, distinct


def initial(c3: list, big: int, mesh=None) -> tuple:
    """The first round on ``text_lanes``: ranks over PACK-symbol prefixes
    (lane order), the lanes in that order, and whether they are distinct."""
    D, m = _shards(c3, mesh)[0], c3[0].shape[0]
    nxt = coll.ppermute([c[:PACK] for c in c3], [(i + 1, i) for i in range(D - 1)], mesh)
    keys = []
    for c, x in zip(c3, nxt):
        ext = torch.cat([c, x]).to(torch.int64)
        key = torch.zeros(m, dtype=torch.int64, device=c.device)
        for j in range(PACK):
            key <<= 3
            key |= ext[j:j + m]
        keys.append(key)
    return _round(keys, big, mesh)


def step(rank: list, h: int, big: int, mesh=None) -> tuple:
    """One doubling round at shift ``h``: ranks over h-prefixes (lane order)
    -> ranks over 2h-prefixes, the sorted lanes, and whether distinct.
    ``rank`` is consumed: once the keys hold it, its tensors' storage is
    released (they are left empty), so that the round's peak does not hold
    it too."""
    D, m = _shards(rank, mesh)[0], rank[0].shape[0]
    gidx = lane_index(rank, mesh)
    # second[i] = rank[i + h] + 1, 0 past the text: whole shards q and q + 1 on
    y = [torch.where(i < big, r + 1, 0) for r, i in zip(rank, gidx)]
    q, r = divmod(h, m)
    recv_a = y if q == 0 else coll.ppermute(y, [(i, i - q) for i in range(q, D)], mesh)
    if r:
        recv_b = coll.ppermute(y, [(i, i - q - 1) for i in range(q + 1, D)], mesh)
        second = [torch.cat([a[r:], b[:r]]) for a, b in zip(recv_a, recv_b)]
    else:
        second = recv_a
    keys = []
    for x, s in zip(rank, second):
        k = x.to(torch.int64)
        k <<= 32
        k |= s
        keys.append(k)
        x.set_()
    del y, recv_a, second
    return _round(keys, big, mesh)


def suffix_array_sharded_arr(codes, mesh) -> list:
    """The suffix array of ``codes`` (uint8 [n], symbols in [0, 6]; host
    numpy or a tensor) + sentinel, sorted over ``mesh``: a list of int32 [m]
    tensors, one a shard on its device, global lanes s*m .. (s+1)*m - 1,
    the first n + 1 lanes holding the suffix array and the pads values at or
    past n + 1 (``shard_lanes`` gives m); across processes, the shards this
    process owns. Symbols are not checked here."""
    codes = np.asarray(codes.cpu() if isinstance(codes, torch.Tensor) else codes, np.uint8)
    n = codes.shape[0]
    check_size(n)
    big = n + 1
    rank, order, distinct = initial(text_lanes(codes, mesh), big, mesh)
    h = PACK
    while not bool(distinct) and h < big:
        del order
        rank, order, distinct = step(rank, h, big, mesh)
        h *= 2
    return order


def gather_rows(xs: list, total: int, mesh=None) -> torch.Tensor:
    """The first ``total`` global rows of a row-sharded array, on the host
    of every process (across processes a replicating ``gather``, the
    counterpart of tpufm's ``_replicated_get``, sa_sharded.py:289)."""
    return host_rows(xs, mesh)[:total]


def host_rows(xs: list, mesh=None) -> torch.Tensor:
    """Every shard's rows (the shards' lengths may differ) concatenated in
    shard order on the host, in every process."""
    if mesh is None or mesh.process_count == 1:
        return torch.cat([x.cpu() for x in xs])
    return coll.gather(xs, mesh).cpu()


def suffix_array_sharded(codes: np.ndarray, mesh=None, device="cuda") -> np.ndarray:
    """Suffix array of ``codes`` + sentinel sorted over ``mesh`` (default
    ``make_mesh(device=device)``: every card, or one CPU shard): int64 [n+1]
    with result[0] == n, as ``host.suffix_array.suffix_array``."""
    if mesh is None:
        from tpufm_torch.parallel.mesh import make_mesh

        mesh = make_mesh(device=device)
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    if codes.shape[0] == 0:
        return np.zeros(1, dtype=np.int64)
    if int(codes.max()) > 6:
        raise ValueError(
            "sharded suffix array supports symbols in [0, 6] "
            f"(got max {int(codes.max())}); use method='native'"
        )
    order = suffix_array_sharded_arr(codes, mesh)
    return gather_rows(order, codes.shape[0] + 1, mesh).numpy().astype(np.int64)


def round_collectives(D: int, m: int, h: int | None = None) -> list:
    """The collectives of one round on D > 1 shards of m lanes, in order, as
    ``recording()`` logs them: (kind, per-shard shape, dtype, bytes between
    shards). ``h`` None is the first round, else the doubling round at
    shift h. Per round: the key's neighbour fetch (the first round: PACK
    lanes from the next shard) or its shift (a whole-shard permute by q =
    h // m shards where q > 0, and by q + 1 where h % m > 0); the global
    sort by key (D transposition rounds, the int64 keys and int32 lanes of
    each pair swapped both ways); the rank (the last key of each shard, the
    shard totals, the count of distinct keys); the global sort by lane (the
    int32 lanes and ranks)."""
    i32, i64 = torch.int32, torch.int64
    out = []
    if h is None:
        out.append(("collective-permute", (PACK,), i32, (D - 1) * PACK * 4))
    else:
        q, r = divmod(h, m)
        if q:
            out.append(("collective-permute", (m,), i32, (D - q) * m * 4))
        if r:
            out.append(("collective-permute", (m,), i32, max(D - q - 1, 0) * m * 4))

    def sort(key_dtype, key_size, pay_dtype, pay_size):
        for rnd in range(D):
            P = (D - rnd % 2) // 2
            if P:
                out.append(("collective-permute", (m,), key_dtype, 2 * P * m * key_size))
                out.append(("collective-permute", (m,), pay_dtype, 2 * P * m * pay_size))

    sort(i64, 8, i32, 4)
    out += [("collective-permute", (1,), i64, (D - 1) * 8), ("all-gather", (D,), i32, D * (D - 1) * 4),
            ("all-reduce", (), i64, D * (D - 1) * 8)]
    sort(i32, 4, i32, 4)
    return out
