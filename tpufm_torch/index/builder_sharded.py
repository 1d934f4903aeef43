"""The k-step FM-index and the locate tables built over a mesh of shards.

Counterpart of tpufm/index/builder_sharded.py (``_table_program`` :36,
``build_index_sharded`` :201, ``_locate_program`` :314,
``build_locate_sharded`` :361). Every O(n) stage runs a shard at a time on
that shard's device, on lists of one tensor a shard
(tpufm_torch.parallel.collectives):

  suffix array  the mesh suffix sort (index.sa_sharded), moved onto
                d-aligned shards of m = d * ceil((n + 1) / (D * d)) rows,
                so that no FM block straddles two shards
  tables        K7 on each shard's rows (``build_tables(..., p0=s*m)``,
                csrc/build_tables.cu) over that shard's copy of the text,
                which each K7 call packs: the planes, the per-block counts
                and the '$' rows the shard holds
  finish        as in ``_table_program`` :61-184: the '$' rows merged by a
                psum; the k-mer at each '$' read back from the planes of the
                shard that owns its block and merged by a psum; the pad
                blocks zeroed, each '$' taken off its 'A'-read k-mer, the
                tail padding off k-mer 0; the exclusive prefix over blocks
                (a cumulative sum a shard plus the all_gather of the shard
                totals) plus C, and the sentinel row

Counters are summed in int64 and kept mod 2^32 (tpufm's uint32
arithmetic). Across processes (a mesh of ``initialize_distributed``) each
process builds the shards it owns, the collectives cross processes, and
``return_host=True`` gives every process the whole host index (tpufm's
``_replicated_get``); ``return_host=False`` leaves each process its own
shards' tables. Every array is bit-identical to ``host.index.build_index`` and
``host.locate.build_locate``. ``return_host=False`` leaves the index as the
``ShardTables`` that ``ShardedIndexEngine`` takes, moved from the build's
ceil(E / D) blocks a shard to the engine's ceil((E + 1) / D) rows a shard
between the shards (a relayout collective), the sentinel row placed on its
owner: no host copy of a table.
"""

from __future__ import annotations

import numpy as np
import torch

from tpufm_torch.bitops import FULL, from_u32_bits, popcount32, to_u32_bits
from tpufm_torch.engine.tables import ShardTables
from tpufm_torch.host.index import IndexConfig, KStepFMIndex, normalize_reference
from tpufm_torch.host.locate import LocateIndex
from tpufm_torch.index.builder_device import _pack_words, build_tables
from tpufm_torch.index.sa_device import upload_text
from tpufm_torch.index.sa_sharded import gather_rows, host_rows, suffix_array_sharded_arr
from tpufm_torch.parallel import collectives as coll


def table_rows(big: int, d: int, D: int) -> int:
    """Rows a shard of the table build holds: whole blocks of d, the n + 1
    rows over D shards."""
    return d * -(-big // (D * d))


def _mesh(mesh):
    if mesh is None:
        from tpufm_torch.parallel.mesh import make_mesh

        mesh = make_mesh()
    return mesh


def _text(codes: np.ndarray, mesh) -> list:
    """The text on every shard's device, one upload a device (colocated
    shards read one copy; nothing writes it)."""
    made = {}
    for dev in mesh.devices:
        if dev not in made:
            made[dev] = upload_text(codes, dev)
    return [made[dev] for dev in mesh.devices]


def _table_sa(codes: np.ndarray, mesh, sa_dev, big: int, d: int) -> list:
    """The suffix array (sorted here, or ``sa_dev`` from
    ``suffix_array_sharded_arr``) on the d-aligned table shards."""
    order = suffix_array_sharded_arr(codes, mesh) if sa_dev is None else sa_dev
    if len(order) != mesh.local_count or order[0].shape[0] * mesh.size < big:
        raise ValueError(f"sa_dev has {len(order)} shards of {order[0].shape[0]} rows; expected "
                         f"{mesh.local_count} of {mesh.size} shards holding {big} rows")
    return coll.relayout(order, big, table_rows(big, d, mesh.size), mesh)


def _dollar_codes(bm: torch.Tensor, dpos: torch.Tensor, s: int, eloc: int, k: int, d: int) -> torch.Tensor:
    """The k-mer at each '$' row whose block shard ``s`` owns (0 for the
    others), int64 [k], from the shard's planes."""
    lb = dpos // d - s * eloc
    mine = (lb >= 0) & (lb < eloc)
    off = dpos % d
    rows = bm[lb.clamp(0, eloc - 1)]  # [k, k, 2, nb]
    words = from_u32_bits(rows[torch.arange(k, device=bm.device), :, :, off // 32])  # [k, k, 2]
    bits = (words >> (31 - off % 32)[:, None, None]) & 1
    shift = 2 * torch.arange(k, device=bm.device)[:, None] + torch.arange(2, device=bm.device)
    return torch.where(mine, (bits << shift).sum(dim=(1, 2)), 0)


def _table_shards(text: list, sa: list, k: int, d: int, big: int, mesh) -> tuple:
    """K7 and the finish a shard: (occ rows int32 [eloc, 4^k] of every
    shard, zero past block E; the sentinel row int64 [4^k] on every shard;
    the planes int32 [eloc, k, 2, nb]; dollar_pos and dollar_base as
    uint32 numpy)."""
    ids, m = mesh.local_shards, sa[0].shape[0]
    eloc, C, E = m // d, 4**k, -(-big // d)
    built = [build_tables(t, x, k, d, p0=s * m, big=big) for s, t, x in zip(ids, text, sa)]
    bm = [b[:eloc] for _, b, _ in built]
    dpos = coll.psum([p for _, _, p in built], mesh)
    dbase = coll.psum([_dollar_codes(b, p, s, eloc, k, d) for s, b, p in zip(ids, bm, dpos)], mesh)
    pad = E * d - big
    inc, counts = [], []
    for s, (c, _, _), p, db in zip(ids, built, dpos, dbase):
        dev = c.device
        blk = s * eloc + torch.arange(eloc, device=dev)
        cnt = torch.zeros((eloc + 1, C), dtype=torch.int64, device=dev)  # row eloc: a scratch row
        cnt[:eloc] = c * (blk < E)[:, None]
        lb = p // d - s * eloc
        lb = torch.where((lb >= 0) & (lb < eloc), lb, eloc)
        cnt.index_put_((lb, db), torch.full((k,), -1, dtype=torch.int64, device=dev), accumulate=True)
        cnt = cnt[:eloc]
        if pad and s == (E - 1) // eloc:
            cnt[(E - 1) % eloc, 0] -= pad
        counts.append(cnt)
        inc.append(torch.cumsum(cnt, dim=0))
    del built
    tots = coll.all_gather([x[-1] for x in inc], mesh)  # [D, C]
    occ, final = [], []
    for s, x, cnt, t, db in zip(ids, inc, counts, tots, dbase):
        dev = x.device
        totals = t.sum(dim=0)
        acc = torch.zeros(C, dtype=torch.int64, device=dev)
        acc[1:] = torch.cumsum(totals, dim=0)[:-1]
        for i in range(k):
            acc += torch.arange(C, device=dev) >= (db[i] & ~((1 << (2 * i)) - 1))
        blk = s * eloc + torch.arange(eloc, device=dev)
        rows = (t[:s].sum(dim=0) + (x - cnt) + acc) * (blk < E)[:, None]
        occ.append(to_u32_bits(rows & FULL))
        final.append((totals + acc) & FULL)
    return occ, final, bm, dpos[0].cpu().numpy().astype(np.uint32), dbase[0].cpu().numpy().astype(np.uint32)


def _host_rows(xs: list, total: int, mesh) -> np.ndarray:
    return gather_rows(xs, total, mesh).numpy().view(np.uint32)


def _index_from_shards(text: list, sa: list, config: IndexConfig, big: int, return_host: bool, mesh):
    k, d, D = config.k, config.d, mesh.size
    E = config.num_entries(big)
    occ, final, bm, dollar_pos, dollar_base = _table_shards(text, sa, k, d, big, mesh)
    if return_host:
        return KStepFMIndex(
            config=config, bwtsize=big,
            occ=np.concatenate([_host_rows(occ, E, mesh), final[0].cpu().numpy().astype(np.uint32)[None]]),
            bitmaps=np.concatenate([_host_rows(bm, E, mesh), np.zeros((1, *bm[0].shape[1:]), np.uint32)]),
            dollar_pos=dollar_pos, dollar_base=dollar_base,
        )
    e_local = -(-(E + 1) // D)
    occ = coll.relayout(occ, E, e_local, mesh)
    owner, first = E // e_local, mesh.local_shards[0]
    if owner in mesh.local_shards:  # the sentinel row (``final`` is the same on every shard)
        occ[owner - first][E % e_local] = to_u32_bits(final[owner - first])
    bitmaps = coll.relayout([b.reshape(b.shape[0], -1) for b in bm], E, e_local, mesh)
    full = lambda xs: [xs[s - first] if s in mesh.local_shards else None for s in range(D)]
    return ShardTables(
        k=k, d=d, bwtsize=big, e_local=e_local, occ=full(occ), bitmaps=full(bitmaps),
        dollar=np.stack([dollar_pos, dollar_base, dollar_pos // np.uint32(d)]), mesh=mesh,
    )


def build_index_sharded(reference, config: IndexConfig = IndexConfig(), mesh=None, sa_dev: list | None = None,
                        return_host: bool = True):
    """The k-step FM-index of ``reference`` built over ``mesh`` (default
    ``make_mesh()``, every card), bit-identical to ``host.index.build_index``.

    ``sa_dev``: the suffix array from ``suffix_array_sharded_arr`` on this
    mesh, so that an index, its k=1 tail and the locate tables share one
    sort. ``return_host=True`` gives the host ``KStepFMIndex``;
    ``return_host=False`` the ``ShardTables`` of ``ShardedIndexEngine``,
    e_local = ceil((E + 1) / D) rows a shard, zero rows at the end (across
    processes, None for the shards another process holds)."""
    mesh = _mesh(mesh)
    codes = normalize_reference(reference)
    big = codes.shape[0] + 1
    sa = _table_sa(codes, mesh, sa_dev, big, config.d)
    return _index_from_shards(_text(codes, mesh), sa, config, big, return_host, mesh)


def build_locate_sharded(reference, sample_rate: int = 32, d: int = 128, mesh=None,
                         sa_dev: list | None = None) -> LocateIndex:
    """The locate tables of ``reference`` built over ``mesh``, bit-identical
    to ``host.locate.build_locate``, from one mesh suffix sort (``sa_dev``,
    else sorted here) shared with the k=1 LF index. A shard's marked rows
    (SA % s == 0) are in row order and the shards are too, so the samples
    are each shard's marked SA values concatenated in shard order: the
    array tpufm's compaction by a global sort gives (:346-352)."""
    mesh = _mesh(mesh)
    codes = normalize_reference(reference)
    big, nb = codes.shape[0] + 1, d // 32
    E = -(-big // d)
    sa = _table_sa(codes, mesh, sa_dev, big, d)
    lf1 = _index_from_shards(_text(codes, mesh), sa, IndexConfig(k=1, d=d), big, True, mesh)
    m = sa[0].shape[0]
    words, per_block, samples = [], [], []
    for s, x in zip(mesh.local_shards, sa):
        marked = (torch.arange(s * m, (s + 1) * m, device=x.device) < big) & (x % sample_rate == 0)
        w = _pack_words(marked.to(torch.int64).view(m // d, nb, 32))
        words.append(to_u32_bits(w))
        per_block.append(popcount32(w).sum(dim=1))
        samples.append(x[marked])
    mark_rank = np.zeros(E + 1, np.uint32)
    mark_rank[1:] = (np.cumsum(gather_rows(per_block, E, mesh).numpy()) & FULL).astype(np.uint32)
    return LocateIndex(
        lf1=lf1, sample_rate=sample_rate,
        mark_words=np.concatenate([_host_rows(words, E, mesh), np.zeros((1, nb), np.uint32)]),
        mark_rank=mark_rank,
        samples=host_rows(samples, mesh).numpy().astype(np.uint32),
    )
