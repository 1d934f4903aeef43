"""Index files: the .fmi images, the .npz archive and the .tpufm store.

Counterparts of tpufm/index/formats.py (``read_fmi`` :112, ``write_fmi`` :56,
``save_npz`` :218, ``load_npz`` :234) and tpufm/index/store.py (``save_store`` :67,
``load_store`` :217: it reads kinds kstep, alt_counters and locate, and
writes kstep and locate, each readable by tpufm; ``save_store_sharded``
:111 and ``load_store_sharded`` :167, the per-shard store). An .fmi
image is a uint32 little-endian header {tag, k, bwtsize, ncounters,
nentries, d}, dollar_pos[k], dollar_base[k], then the entry table:

  tag 100 / 101  bitmap words, then 4^k counters per entry (101: bitmap
                 words regrouped by window, level, plane)
  tag 200 / 201  4^k/2 counters (even entries the low half, odd entries the
                 high half), then bitmap words, plus one appended
                 end-of-text entry

Every image reads back into the full logical index (an alternate-counters
image as an ``AltCountersIndex`` around it). For an alternate-counters image
with an even number of entries and a partial last block, tpufm's reader
carries the last block's padding into the logical counters of the last
entry and the sentinel (k-mer 0); this reader does not, so the logical index
equals the one the image was written from. ``write_fmi`` writes all four
tags.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from tpufm_torch.host.bitplanes import block_kmer_counts
from tpufm_torch.host.index import (
    AltCountersIndex,
    IndexConfig,
    KStepFMIndex,
    Layout,
    c_array,
)
from tpufm_torch.host.layouts import deinterleave_bitmap_words, interleave_bitmap_words, make_alt_counters
from tpufm_torch.host.locate import LocateIndex

_U32 = np.dtype("<u4")


def write_fmi(path, index: KStepFMIndex, layout: Layout = Layout.BASELINE) -> None:
    """An .fmi image of ``index`` in any of the four layouts: tag 100
    (baseline), 101 (interleaved), 200 (alternate counters) or 201
    (interleaved alternate counters), byte-identical to tpufm's
    (tpufm/index/formats.py:56-84). Tags 200/201 take the reference's
    appended-entry arithmetic (``make_alt_counters(reference_semantics=True)``)
    and one all-zero appended bitmap row."""
    cfg, E = index.config, index.nentries
    bm = index.bitmaps[:E]
    if layout.interleaved:
        bm = interleave_bitmap_words(bm)
    bm = bm.reshape(E, -1)
    head = [layout.fmi_tag, cfg.k, index.bwtsize]
    if layout.has_slim_counters:
        S = cfg.num_slim_counters
        entries = np.zeros((E + 1, S + cfg.bitmap_words), dtype=_U32)
        entries[:, :S] = make_alt_counters(index, reference_semantics=True).occ_slim[:E + 1]
        entries[:E, S:] = bm
        head += [S, E + 1]
    else:
        entries = np.concatenate([bm, index.occ[:E]], axis=1).astype(_U32)
        head += [cfg.num_counters, E]
    head += [cfg.d] + [int(x) for x in index.dollar_pos] + [int(x) for x in index.dollar_base]
    with open(path, "wb") as fp:
        np.asarray(head, dtype=_U32).tofile(fp)
        entries.tofile(fp)


def read_fmi(path) -> tuple[KStepFMIndex | AltCountersIndex, Layout]:
    """Any .fmi image, as the logical index and the layout it was stored in."""
    with open(path, "rb") as fp:
        tag, k, bwtsize, ncounters, n_file, d = (int(x) for x in np.fromfile(fp, _U32, 6))
        layout = Layout.from_fmi_tag(tag)
        dollar_pos = np.fromfile(fp, _U32, k)
        dollar_base = np.fromfile(fp, _U32, k)
        cfg = IndexConfig(k=k, d=d, layout=layout)
        S = cfg.num_slim_counters if layout.has_slim_counters else cfg.num_counters
        if ncounters != S:
            raise ValueError(f"tag {tag} with {ncounters} counters, expected {S}")
        entries = np.fromfile(fp, _U32, n_file * (S + cfg.bitmap_words))
    entries = entries.reshape(n_file, S + cfg.bitmap_words)
    # alternate counters: counters first, and one appended end-of-text entry
    E = n_file - 1 if layout.has_slim_counters else n_file
    bm = entries[:E, S:] if layout.has_slim_counters else entries[:, :cfg.bitmap_words]
    nb = cfg.words_per_plane
    bitmaps = np.zeros((E + 1, k, 2, nb), dtype=np.uint32)
    if layout.interleaved:
        bitmaps[:E] = deinterleave_bitmap_words(bm.reshape(E, nb, k, 2))
    else:
        bitmaps[:E] = bm.reshape(E, k, 2, nb)
    index = KStepFMIndex(
        config=cfg, bwtsize=bwtsize,
        occ=np.zeros((E + 1, 4**k), dtype=np.uint32), bitmaps=bitmaps,
        dollar_pos=dollar_pos, dollar_base=dollar_base,
    )
    if not layout.has_slim_counters:
        index.occ[:E] = entries[:, cfg.bitmap_words:]
        # the sentinel row: the last entry plus its block's '$'-exclusive
        # k-mer counts over the block's real positions
        last = block_kmer_counts(bitmaps[E - 1:E], k, prefix=bwtsize - (E - 1) * d)[0]
        for i in range(k):
            if int(dollar_pos[i]) // d == E - 1:
                last[int(dollar_base[i])] -= 1
        index.occ[E] = (index.occ[E - 1] + last).astype(np.uint32)
        return index, layout
    occ_slim = np.zeros((E + 2, S), dtype=np.uint32)
    occ_slim[:n_file] = entries[:, :S]
    _fill_alt_counters(index, occ_slim)
    return AltCountersIndex(base=index, occ_slim=occ_slim), layout


def _fill_alt_counters(index: KStepFMIndex, occ_slim: np.ndarray) -> None:
    """Complete ``index.occ`` from the stored half rows of an alternate-
    counters image, and make ``occ_slim``'s appended row '$'-exclusive and
    its last (safety) row the true end-of-text counters.

    Entry e stores counters [0, S) if e is even and [S, 2S) if odd; the
    other half is the next row's stored values minus e's block counts.
    """
    cfg, E, d = index.config, index.nentries, index.config.d
    S, k = cfg.num_slim_counters, cfg.k
    bwtsize, dollar_pos, dollar_base = index.bwtsize, index.dollar_pos, index.dollar_base
    # '$'-exclusive k-mer counts of every real block, from the bit-planes
    counts = block_kmer_counts(index.bitmaps[:E], k)
    for i in range(k):
        counts[int(dollar_pos[i]) // d, int(dollar_base[i])] -= 1
    pad = E * d - bwtsize
    counts[E - 1, 0] -= pad  # the last block's padding reads as 'A'
    half = S if E % 2 else 0  # the half stored in the appended row
    if bwtsize % d:
        # the image's appended row counts a '$' of the last block as its k-mer
        in_last = dollar_pos // d == E - 1
        for c in range(S):
            occ_slim[E, c] -= np.uint32(np.sum(in_last & (dollar_base == half + c)))
    else:
        # the image's appended row is not meaningful; rebuild it and the
        # safety row from the totals and the '$' metadata
        totals = counts.sum(axis=0)
        end = (c_array(totals, dollar_base, k) + totals).astype(np.uint32)
        occ_slim[E] = end[half:half + S]
        other = S - half
        occ_slim[E + 1] = end[other:other + S]
        if other == 0:
            occ_slim[E + 1, 0] += np.uint32(d)
    occ = index.occ
    even = np.arange(E) % 2 == 0
    occ[:E][even, :S] = occ_slim[:E][even]
    occ[:E][~even, S:] = occ_slim[:E][~even]
    nxt = occ_slim[1:E + 1].astype(np.int64)
    if half == 0:
        # the appended row counts the last block's padding as 'A' k-mers (the
        # alternate-counters search subtracts them again); the sentinel does not
        nxt[-1, 0] -= pad
    occ[E, half:half + S] = nxt[-1]
    occ[:E][even, S:] = (nxt[even] - counts[even][:, S:]).astype(np.uint32)
    occ[:E][~even, :S] = (nxt[~even] - counts[~even][:, :S]).astype(np.uint32)
    other = S - half
    occ[E, other:other + S] = (
        occ[E - 1, other:other + S].astype(np.int64) + counts[E - 1, other:other + S]
    ).astype(np.uint32)


def save_npz(path, index: KStepFMIndex) -> None:
    """The .npz archive of an index: the arrays tpufm's ``save_npz`` writes,
    in its order, so that the files are byte-identical (zip members carry
    their write time)."""
    np.savez_compressed(
        path,
        version=np.int32(1),
        k=np.int32(index.config.k),
        d=np.int32(index.config.d),
        layout=np.bytes_(index.config.layout.value.encode()),
        bwtsize=np.int64(index.bwtsize),
        occ=index.occ,
        bitmaps=index.bitmaps,
        dollar_pos=index.dollar_pos,
        dollar_base=index.dollar_base,
    )


def load_npz(path) -> KStepFMIndex:
    """The .npz archive of an index (``save_npz``, tpufm's save_npz)."""
    with np.load(path) as z:
        cfg = IndexConfig(k=int(z["k"]), d=int(z["d"]),
                          layout=Layout(bytes(z["layout"]).decode()))
        return KStepFMIndex(
            config=cfg, bwtsize=int(z["bwtsize"]), occ=z["occ"], bitmaps=z["bitmaps"],
            dollar_pos=z["dollar_pos"], dollar_base=z["dollar_base"],
        )


_KSTEP = ("occ", "bitmaps", "dollar_pos", "dollar_base")
_LOCATE = ("mark_words", "mark_rank", "samples")
#: the store format this module reads and writes (tpufm/index/store.py FORMAT)
STORE_FORMAT = 1


def _store_root(path) -> Path:
    return Path(str(path) if str(path).endswith(".tpufm") else f"{path}.tpufm")


def _kstep_meta(index: KStepFMIndex) -> dict:
    cfg = index.config
    return {"k": cfg.k, "d": cfg.d, "layout": cfg.layout.value, "bwtsize": index.bwtsize}


def _kstep_from(meta: dict, arr: dict) -> KStepFMIndex:
    return KStepFMIndex(
        config=IndexConfig(k=meta["k"], d=meta["d"], layout=Layout(meta["layout"])),
        bwtsize=meta["bwtsize"], occ=arr["occ"], bitmaps=arr["bitmaps"],
        dollar_pos=np.asarray(arr["dollar_pos"]), dollar_base=np.asarray(arr["dollar_base"]),
    )


def save_store(path, index: KStepFMIndex | LocateIndex) -> Path:
    """Write a k-step index (kind ``kstep``) or locate tables (kind
    ``locate``) as a ``<path>.tpufm`` store directory in tpufm's layout
    (tpufm/index/store.py:67-108): one ``.npy`` per array, the locate
    tables' k=1 index under the prefix ``lf1_``, and ``meta.json``."""
    root = _store_root(path)
    if isinstance(index, LocateIndex):
        meta = {"kind": "locate", "format": STORE_FORMAT, "sample_rate": index.sample_rate,
                **{f"lf1_{k}": v for k, v in _kstep_meta(index.lf1).items()}}
        arrays = {**{f"lf1_{n}": getattr(index.lf1, n) for n in _KSTEP},
                  **{n: getattr(index, n) for n in _LOCATE}}
    elif isinstance(index, KStepFMIndex):
        meta = {"kind": "kstep", "format": STORE_FORMAT, **_kstep_meta(index)}
        arrays = {n: getattr(index, n) for n in _KSTEP}
    else:
        raise TypeError(f"cannot store {type(index).__name__} (kinds kstep and locate)")
    root.mkdir(parents=True, exist_ok=True)
    for name, a in arrays.items():
        np.save(root / f"{name}.npy", np.ascontiguousarray(a))
    (root / "meta.json").write_text(json.dumps(meta, indent=1))
    return root


def load_store(path, mmap: bool = True) -> KStepFMIndex | AltCountersIndex | LocateIndex:
    """A ``.tpufm`` store directory of a k-step or alternate-counters index
    or of locate tables, its arrays memory-mapped unless ``mmap`` is false.
    Other kinds of store raise ValueError."""
    root = _store_root(path)
    meta = json.loads((root / "meta.json").read_text())
    if meta.get("format", 0) > STORE_FORMAT:
        raise ValueError(f"store format {meta['format']} is newer than supported ({STORE_FORMAT})")
    kind = meta["kind"]

    def arrays(names, prefix=""):
        return {n: np.load(root / f"{prefix}{n}.npy", mmap_mode="r" if mmap else None) for n in names}

    if kind == "locate":
        lf1 = _kstep_from({k[4:]: v for k, v in meta.items() if k.startswith("lf1_")},
                          arrays(_KSTEP, "lf1_"))
        return LocateIndex(lf1=lf1, sample_rate=meta["sample_rate"], **arrays(_LOCATE))
    if kind not in ("kstep", "alt_counters"):
        raise ValueError(f"{root} holds a {kind!r} store, not a k-step index or locate tables")
    arr = arrays(_KSTEP + (("occ_slim",) if kind == "alt_counters" else ()))
    index = _kstep_from(meta, arr)
    return AltCountersIndex(base=index, occ_slim=arr["occ_slim"]) if kind == "alt_counters" else index


def save_store_sharded(path, tables) -> Path:
    """Write the ``ShardTables`` of a sharded index
    (``build_index_sharded(..., return_host=False)``) as a per-shard store
    (kind ``kstep_sharded``, tpufm/index/store.py:111-164): each shard's
    tables copied from its own tensors into ``occ.shard%04d.npy`` (uint32
    [rows/D, 4^k]) and ``bitmaps.shard%04d.npy`` ([rows/D, k, 2, nb]), with
    ``dollar_pos.npy``, ``dollar_base.npy`` and ``meta.json``; the files are
    tpufm's, byte for byte. No table is assembled whole. Across processes
    (tables on a mesh of ``initialize_distributed``; every process calls
    this) each process writes its own shards' files and process 0 alone the
    shared ones (tpufm's store.py:148); all wait for each other before
    returning, so that any may read the store then."""
    from tpufm_torch.engine.tables import ShardTables, host_words

    if not isinstance(tables, ShardTables):
        raise TypeError("save_store_sharded expects row-sharded tables "
                        "(build_index_sharded(..., return_host=False)); use "
                        "save_store for host indexes")
    root = _store_root(path)
    root.mkdir(parents=True, exist_ok=True)
    nb = tables.d // 32
    mesh = tables.mesh
    across = mesh is not None and mesh.process_count > 1
    if not across and any(x is None for x in tables.occ):
        raise ValueError("save_store_sharded: some shards are missing and the tables name no multi-process mesh")
    for s in range(tables.n_shards):
        if tables.occ[s] is None:  # another process's shard: that process writes it
            continue
        np.save(root / f"occ.shard{s:04d}.npy", np.ascontiguousarray(host_words(tables.occ[s])))
        np.save(root / f"bitmaps.shard{s:04d}.npy", np.ascontiguousarray(
            host_words(tables.bitmaps[s]).reshape(tables.e_local, tables.k, 2, nb)))
    if not across or mesh.process_index == 0:
        np.save(root / "dollar_pos.npy", np.ascontiguousarray(tables.dollar[0], np.uint32))
        np.save(root / "dollar_base.npy", np.ascontiguousarray(tables.dollar[1], np.uint32))
        meta = {"kind": "kstep_sharded", "format": STORE_FORMAT, "n_shards": tables.n_shards,
                "rows": tables.n_shards * tables.e_local, "k": tables.k, "d": tables.d,
                "layout": Layout.BASELINE.value, "bwtsize": tables.bwtsize}
        (root / "meta.json").write_text(json.dumps(meta, indent=1))
    if across:
        import torch.distributed as dist

        dist.barrier()
    return root


def load_store_sharded(path, mesh):
    """A per-shard store as ``ShardTables`` on ``mesh``, each shard's files
    read and put on that shard's device (no whole-table copy). The mesh
    must have as many shards as the store (tpufm/index/store.py:167-214).
    Across processes each process reads only the shards it owns (None for
    the others')."""
    import torch

    from tpufm_torch.engine.tables import ShardTables

    root = _store_root(path)
    meta = json.loads((root / "meta.json").read_text())
    if meta.get("format", 0) > STORE_FORMAT:
        raise ValueError(f"store format {meta['format']} is newer than supported ({STORE_FORMAT})")
    if meta["kind"] != "kstep_sharded":
        raise ValueError(f"not a sharded store: kind={meta['kind']!r}")
    n_shards, rows = meta["n_shards"], meta["rows"]
    if mesh.size != n_shards:
        raise ValueError(f"store has {n_shards} shards; mesh has {mesh.size} devices "
                         "(per-shard stores reload onto an equal-size mesh)")
    e_local, k, d = rows // n_shards, meta["k"], meta["d"]

    def shard(name, s):
        a = np.load(root / f"{name}.shard{s:04d}.npy").reshape(e_local, -1)
        return torch.from_numpy(a.view(np.int32)).to(device[s])

    dollar_pos = np.load(root / "dollar_pos.npy").astype(np.uint32)
    device = dict(zip(mesh.local_shards, mesh.devices))
    return ShardTables(
        k=k, d=d, bwtsize=meta["bwtsize"], e_local=e_local,
        occ=[shard("occ", s) if s in device else None for s in range(n_shards)],
        bitmaps=[shard("bitmaps", s) if s in device else None for s in range(n_shards)],
        dollar=np.stack([dollar_pos, np.load(root / "dollar_base.npy").astype(np.uint32),
                         dollar_pos // np.uint32(d)]),
        mesh=mesh,
    )
