"""The engine's state: the tables of each layout, '$' metadata and the
prefix LUT.

Counterparts of the table branches of ``XLAEngine.__init__``
(tpufm/engine/xla.py:597-640): the fused entries (``build_fused_entries``,
xla.py:1405, with ``pad_words``), the split layout's bit-planes and counters,
the alternate-counters layout's bit-planes and slim counters (``occ_slim``,
tpufm/index/layouts.py:97-136) and the paired table
(``build_paired_entries``, xla.py:1391); of the LUT cache (``lut_with_cache``,
xla.py:1427-1472); and the bridge from the JAX engine's state
(``XLAEngine.tables`` of every layout) to the port's, so that both engines
can compute on identical tables. Tables are host numpy, which the engine
(search.py) moves to its device, or, for an index built on the device
(``build_index_device(return_host=False)``), int32 tensors holding the
uint32 words, concatenated where they lie (xla.py:1367-1371). The sharded
engine's state is ``ShardTables``: the split tables cut along the entry axis
(``shard_tables``, tpufm/parallel/search.py:546-569), or ported from
tpufm's sharded engine (``shards_from_jax``).
"""

from __future__ import annotations

import dataclasses
import os
import zlib

import numpy as np
import torch

from tpufm_torch.host.index import AltCountersIndex, IndexConfig, KStepFMIndex

#: largest prefix LUT the npz cache persists: the same ceiling as the JAX
#: engine's LUT_CACHE_MAX_BYTES (xla.py:1424), so both write the same files
LUT_CACHE_MAX_BYTES = 512 * 1024 * 1024


@dataclasses.dataclass
class Tables:
    """Host state of one search engine, in one of four layouts (``layout``):

    entries: uint32 [E+1, W] fused rows: 2k*nb bit-plane words (level, plane,
        window), then the 4^k counters, then zeros up to ``pad_words``; row
        E is the end-of-text sentinel (or an int32 tensor of the same bits,
        for a device-built index). The fused and paired layouts; None in
        the split and alternate-counters layouts.
    entries_paired: uint32 [E+1, 2W]: row i is fused rows i and i+1 side by
        side, the last row's second half zeros (paired layout), else None.
    bitmaps: uint32 [E+1, 2k*nb] the bit-plane words of every entry (split
        and alternate-counters layouts), else None.
    occ: uint32 [E+1, 4^k] the counters (split layout), else None.
    occ_slim: uint32 [E+2, 4^k / 2] the alternate counters: each entry's
        stored half, the appended end-of-text row and the safety row
        (alternate-counters layout), else None.
    dollar: uint32 [3, k]: rows dollar_pos, dollar_base, dollar_block.
    tail_*: the k=1 table (sample distance tail_d) that finishes reads whose
        length leaves L mod k characters, or None.
    lut: uint32 [4^m, 2] SA interval of every m-mer, or None.
    """

    k: int
    d: int
    bwtsize: int
    entries: np.ndarray | None
    dollar: np.ndarray
    tail_d: int | None = None
    tail_entries: np.ndarray | None = None
    tail_dollar: np.ndarray | None = None
    lut: np.ndarray | None = None
    entries_paired: np.ndarray | None = None
    bitmaps: np.ndarray | None = None
    occ: np.ndarray | None = None
    occ_slim: np.ndarray | None = None

    @property
    def layout(self) -> str:
        """"fused", "split", "paired" or "alt_counters" (the split walk on
        the slim counters), by the tables present."""
        if self.occ_slim is not None:
            return "alt_counters"
        if self.entries_paired is not None:
            return "paired"
        return "fused" if self.entries is not None else "split"


def concat_words(parts: list) -> np.ndarray | torch.Tensor:
    """Word tables [rows, *] side by side: host numpy as uint32, or int32
    tensors (uint32 bits) on the device where they lie, never through the
    host."""
    if isinstance(parts[0], torch.Tensor):
        return torch.cat([p.reshape(p.shape[0], -1) for p in parts], dim=1)
    return np.concatenate(
        [np.asarray(p).reshape(p.shape[0], -1) for p in parts], axis=1
    ).astype(np.uint32, copy=False)


def host_words(a) -> np.ndarray:
    """A word table as host numpy uint32 (an int32 tensor's bits)."""
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy().view(np.uint32)
    return np.asarray(a)


def build_fused_entries(index: KStepFMIndex, pad_words: int | None = None) -> np.ndarray | torch.Tensor:
    """uint32 [E+1, max(2k*nb + 4^k, pad_words)]: bitmap words then counters
    per entry, then zeros up to ``pad_words`` (xla.py:1405-1419); an int32
    tensor on the device for a device-resident index."""
    entries = concat_words([index.bitmaps, index.occ])
    if pad_words and pad_words > entries.shape[1]:
        pad = (0, pad_words - entries.shape[1])
        if isinstance(entries, torch.Tensor):
            return torch.nn.functional.pad(entries, pad)
        return np.pad(entries, ((0, 0), pad))
    return entries


def build_paired_entries(entries: np.ndarray | torch.Tensor) -> np.ndarray | torch.Tensor:
    """[E+1, W] fused table -> [E+1, 2W] paired table: row i carries fused
    rows i and i+1 side by side, the last row's second half zeros
    (xla.py:1391-1402); numpy, or int32 tensors where they lie."""
    if isinstance(entries, torch.Tensor):
        last = torch.nn.functional.pad(entries[-1:], (0, entries.shape[1]))
        return torch.cat([torch.cat([entries[:-1], entries[1:]], dim=1), last])
    last = np.pad(entries[-1:], ((0, 0), (0, entries.shape[1])))
    return np.concatenate([np.concatenate([entries[:-1], entries[1:]], axis=1), last])


def _dollar(index: KStepFMIndex) -> np.ndarray:
    return np.stack(
        [index.dollar_pos, index.dollar_base, index.dollar_block]
    ).astype(np.uint32)


def is_alt_counters(index) -> bool:
    """Whether ``index`` is an alternate-counters index (the port's, or any
    object with ``base`` and ``occ_slim``, such as tpufm's)."""
    return getattr(index, "occ_slim", None) is not None


def tables_from_index(
    index: KStepFMIndex | AltCountersIndex,
    tail_index: KStepFMIndex | None = None,
    layout: str = "fused",
    pad_words: int | None = None,
) -> Tables:
    """The engine's tables for ``index`` in ``layout`` (xla.py:597-640):
    "fused" (rows padded to ``pad_words``), "paired" (the fused rows and the
    paired table), or any other name the split tables, whose counters are
    ``occ_slim`` for an alternate-counters index and ``occ`` otherwise (the
    fused and paired layouts of an alternate-counters index are its base's);
    and, for reads of any length, the k=1 ``tail_index`` over the same
    text."""
    base = getattr(index, "base", index)
    tables = Tables(
        k=base.config.k,
        d=base.config.d,
        bwtsize=int(base.bwtsize),
        entries=None,
        dollar=_dollar(base),
    )
    if layout == "fused":
        tables.entries = build_fused_entries(base, pad_words)
    elif layout == "paired":
        tables.entries = build_fused_entries(base)
        tables.entries_paired = build_paired_entries(tables.entries)
    else:
        rows = base.occ.shape[0]
        tables.bitmaps = base.bitmaps.reshape(rows, -1)
        if is_alt_counters(index):
            tables.occ_slim = index.occ_slim
        else:
            tables.occ = base.occ
    if tail_index is not None:
        if tail_index.config.k != 1:
            raise ValueError(
                f"tail_index must be a k=1 index, got k={tail_index.config.k}"
            )
        if tail_index.bwtsize != base.bwtsize:
            raise ValueError(
                f"tail_index bwtsize {tail_index.bwtsize} != index bwtsize "
                f"{base.bwtsize} (different texts?)"
            )
        tables.tail_d = tail_index.config.d
        tables.tail_entries = build_fused_entries(tail_index)
        tables.tail_dollar = _dollar(tail_index)
    return tables


def _shape_of(entries: np.ndarray, k: int) -> int:
    """Sample distance d of an unpadded fused table with k levels."""
    bmw = entries.shape[1] - 4**k
    if bmw <= 0 or bmw % (2 * k):
        raise ValueError(
            f"fused rows of {entries.shape[1]} words do not hold k={k} "
            "(for padded rows pass d)"
        )
    return 32 * (bmw // (2 * k))


def _check_d(d: int, name: str = "d") -> None:
    if d <= 0 or d % 32:
        raise ValueError(f"{name} must be a positive multiple of 32, got {d}")


def tables_from_jax(tables: dict, d: int | None = None, tail_d: int | None = None) -> Tables:
    """Port the JAX engine's state (``XLAEngine(...).tables`` of any layout:
    fused, split, alternate-counters or paired, xla.py:597-640) to the
    port's tables, including an already-built ``lut`` and tail table, so
    that both engines compute on identical state.

    k is the number of '$' levels. The split and alternate-counters tables
    give d by their bit-plane words ([E+1, k, 2, nb]). Of fused rows, without
    ``d``, d follows from the row width, which must then be unpadded. With
    the sample distance ``d``, rows padded past 2k*nb + 4^k words
    (``pad_words``, or ``gather="dma"``'s 128-word rows, xla.py:612-618) are
    accepted: the padding must be zeros, as ``build_fused_entries`` writes it
    (xla.py:1413-1417), and is dropped. A paired table must be the pairs of
    the fused rows it comes with.
    bwtsize is the sentinel's last counter: that counter is C[4^k - 1] plus
    the whole text's count of the last k-mer, i.e. every position except the
    k '$' positions, plus one '$' increment per level. Of the alternate
    counters it is the last slim counter of whichever of the appended and
    the safety row holds the upper half (the odd one of rows E, E+1).

    The k=1 tail table likewise: without ``tail_d`` its rows must be exactly
    2*nb + 4 words; with it, wider rows are kept whole, such as the fused
    locate rows that the JAX search+locate state carries as its tail
    (xla.py:1183-1189: 3*nb + 5 words, the mark columns past the counters,
    which the LF round never reads). Either way the tail's row count must be
    ceil(bwtsize / tail_d) + 1, or the row width was misread.
    """
    arr = {name: np.asarray(v) for name, v in tables.items()}
    k = int(arr["dollar_pos"].shape[0])
    dollar = np.stack([arr["dollar_pos"], arr["dollar_base"], arr["dollar_block"]]).astype(np.uint32)
    if "bitmaps" in arr:  # split or alternate counters
        bitmaps = arr["bitmaps"].astype(np.uint32, copy=False)
        if bitmaps.ndim != 4 or bitmaps.shape[1:3] != (k, 2):
            raise ValueError(f"bitmaps of shape {bitmaps.shape} do not hold k={k} levels [E+1, k, 2, nb]")
        d = 32 * bitmaps.shape[3]
        out = Tables(k=k, d=d, bwtsize=0, entries=None, dollar=dollar,
                     bitmaps=bitmaps.reshape(bitmaps.shape[0], -1))
        if "occ_slim" in arr:
            out.occ_slim = arr["occ_slim"].astype(np.uint32, copy=False)
            E = out.occ_slim.shape[0] - 2
            out.bwtsize = int(out.occ_slim[E | 1, -1])
        else:
            out.occ = arr["occ"].astype(np.uint32, copy=False)
            out.bwtsize = int(out.occ[-1, -1])
        entries = out.bitmaps
    else:
        entries = arr["entries"].astype(np.uint32, copy=False)
        if d is None:
            d = _shape_of(entries, k)
        else:
            _check_d(d)
            width = 2 * k * (d // 32) + 4**k
            if entries.shape[1] < width:
                raise ValueError(f"fused rows of {entries.shape[1]} words cannot hold k={k} d={d} ({width} words)")
            if entries[:, width:].any():
                raise ValueError(f"fused rows carry non-zero words past the {width} of k={k} d={d}")
            entries = entries[:, :width]
        out = Tables(k=k, d=d, bwtsize=int(entries[-1, -1]), entries=entries, dollar=dollar)
        if "entries_paired" in arr:
            paired = arr["entries_paired"].astype(np.uint32, copy=False)
            if not np.array_equal(paired, build_paired_entries(entries)):
                raise ValueError("entries_paired are not the pairs of the fused rows")
            out.entries_paired = paired
    if entries.shape[0] != -(-out.bwtsize // d) + 1 or not np.array_equal(
        out.dollar[2], out.dollar[0] // np.uint32(d)
    ):
        raise ValueError(
            f"tables do not fit k={k} d={d} (row count or dollar_block); "
            "for padded rows pass d"
        )
    if "tail_entries" in arr:
        tail = arr["tail_entries"].astype(np.uint32, copy=False)
        if tail_d is None:
            tail_d = _shape_of(tail, 1)
        else:
            _check_d(tail_d, "tail_d")
            if tail.shape[1] < 2 * (tail_d // 32) + 4:
                raise ValueError(f"tail rows of {tail.shape[1]} words cannot hold k=1 d={tail_d}")
        out.tail_d, out.tail_entries = tail_d, tail
        out.tail_dollar = np.stack(
            [arr["tail_dollar_pos"], arr["tail_dollar_base"], arr["tail_dollar_block"]]
        ).astype(np.uint32)
        if tail.shape[0] != -(-out.bwtsize // tail_d) + 1 or not np.array_equal(
            out.tail_dollar[2], out.tail_dollar[0] // np.uint32(tail_d)
        ):
            raise ValueError(
                f"tail table of {tail.shape[0]} rows x {tail.shape[1]} words does not "
                f"fit k=1 d={tail_d} (row count or dollar_block); for rows wider than "
                "2*nb + 4 words, such as the fused locate rows, pass tail_d"
            )
    elif tail_d is not None:
        raise ValueError("tail_d given, but the tables carry no tail_entries")
    if "lut" in arr:
        out.lut = arr["lut"].astype(np.uint32, copy=False)
    return out


@dataclasses.dataclass
class ShardTables:
    """The state of the sharded-index engine (tpufm/parallel/search.py:
    546-604): the split tables cut along the entry axis into D shards of
    ``e_local`` rows each, zero rows padded at the end, and what every shard
    holds whole.

    occ: D tables uint32 [e_local, 4^k], shard s holding entries s*e_local ..
        (s+1)*e_local - 1 (host numpy, or int32 tensors of the same bits where
        the index lies on a device; None for a shard that another process
        of ``mesh`` holds).
    bitmaps: D tables uint32 [e_local, 2k*nb], likewise.
    dollar: uint32 [3, k] rows dollar_pos, dollar_base, dollar_block (global
        blocks), replicated.
    tail_*: the k=1 tail table (fused rows), replicated, or None.
    lut: uint32 [4^m, 2] prefix LUT, replicated, or None.
    mesh: the mesh the shards were built or loaded on, or None (cut on the
        host or from one device's index).
    """

    k: int
    d: int
    bwtsize: int
    e_local: int
    occ: list
    bitmaps: list
    dollar: np.ndarray
    tail_d: int | None = None
    tail_entries: np.ndarray | None = None
    tail_dollar: np.ndarray | None = None
    lut: np.ndarray | None = None
    mesh: object = None

    @property
    def n_shards(self) -> int:
        return len(self.occ)

    @property
    def nentries(self) -> int:
        return -(-self.bwtsize // self.d)

    def host_index(self) -> KStepFMIndex:
        """The index on the host, every shard's rows copied there: E + 1
        rows and the zero rows that pad them to D * e_local, as tpufm's
        index of row-sharded arrays holds them. Every shard must be in this
        process (across processes, build with ``return_host=True``)."""
        if any(x is None for x in self.occ):
            raise ValueError("host_index: other processes hold some of these shards; build the index with "
                             "return_host=True for a host copy in every process")
        rows = lambda xs: np.concatenate([host_words(x) for x in xs])
        return KStepFMIndex(config=IndexConfig(k=self.k, d=self.d), bwtsize=self.bwtsize, occ=rows(self.occ),
                            bitmaps=rows(self.bitmaps).reshape(-1, self.k, 2, self.d // 32),
                            dollar_pos=self.dollar[0].copy(), dollar_base=self.dollar[1].copy())


def _split_rows(table, n: int, e_local: int) -> list:
    """``table`` [rows, W] padded with zero rows to n * e_local and cut into n
    shards of e_local rows: host numpy, or int32 tensors padded and cut where
    they lie (no copy through the host; the shards are views of one padded
    tensor)."""
    pad = n * e_local - table.shape[0]
    if isinstance(table, torch.Tensor):
        table = torch.nn.functional.pad(table, (0, 0, 0, pad))
    else:
        table = np.pad(np.asarray(table, dtype=np.uint32), ((0, pad), (0, 0)))
    return [table[s * e_local:(s + 1) * e_local] for s in range(n)]


def shard_tables(index: KStepFMIndex, n_shards: int, tail_index: KStepFMIndex | None = None) -> ShardTables:
    """``index`` split along its entry axis into ``n_shards`` shards:
    ``total = occ.shape[0]``, ``e_local = ceil(total / n_shards)``, zero rows
    padded at the end (tpufm/parallel/search.py:546-569); for an index built
    on the device (``build_index_device(return_host=False)``) padded and cut
    on that device. The k=1 ``tail_index`` comes along whole, as fused rows
    (its checks are the engine's)."""
    total = index.occ.shape[0]
    e_local = -(-total // n_shards)
    tables = ShardTables(
        k=index.config.k, d=index.config.d, bwtsize=int(index.bwtsize), e_local=e_local,
        occ=_split_rows(index.occ, n_shards, e_local),
        bitmaps=_split_rows(index.bitmaps.reshape(total, -1), n_shards, e_local),
        dollar=_dollar(index),
    )
    return tables if tail_index is None else with_tail(tables, tail_index)


def with_tail(tables: ShardTables, tail_index: KStepFMIndex) -> ShardTables:
    """``tables`` with the k=1 ``tail_index`` beside them, whole, as fused
    rows (its checks are the engine's)."""
    return dataclasses.replace(tables, tail_d=tail_index.config.d, tail_entries=build_fused_entries(tail_index),
                               tail_dollar=_dollar(tail_index))


def shards_from_jax(eng) -> ShardTables:
    """Port a tpufm ``ShardedIndexEngine``'s state to the port's shards: its
    entry-sharded ``occ`` [D*e_local, 4^k] and ``bitmaps`` [D*e_local, k, 2,
    nb], its replicated '$' triple, k=1 tail and (with ``lut_m``) prefix LUT,
    as arrays numpy can read (``np.asarray``), so that both engines compute
    on the same split."""
    occ = np.asarray(eng.occ).astype(np.uint32, copy=False)
    bitmaps = np.asarray(eng.bitmaps).astype(np.uint32, copy=False)
    e_local = int(eng.e_local)
    n = occ.shape[0] // e_local
    if n * e_local != occ.shape[0] or bitmaps.shape[0] != occ.shape[0]:
        raise ValueError(f"tables of {occ.shape[0]} rows are not shards of {e_local} rows")
    tables = ShardTables(
        k=int(eng.config.k), d=int(eng.config.d), bwtsize=int(eng.bwtsize), e_local=e_local,
        occ=[occ[s * e_local:(s + 1) * e_local] for s in range(n)],
        bitmaps=[bitmaps[s * e_local:(s + 1) * e_local].reshape(e_local, -1) for s in range(n)],
        dollar=np.stack([np.asarray(x) for x in eng.dollar]).astype(np.uint32),
    )
    if eng.tail_d is not None:
        tables.tail_d = int(eng.tail_d)
        tables.tail_entries = np.asarray(eng.tail[0]).astype(np.uint32, copy=False)
        tables.tail_dollar = np.stack([np.asarray(x) for x in eng.tail[1:]]).astype(np.uint32)
    if eng.lut_m:
        tables.lut = np.asarray(eng.lut).astype(np.uint32, copy=False)
    return tables


def lut_fingerprint(index: KStepFMIndex, lut_m: int) -> np.ndarray:
    """uint64 fingerprint of the index a LUT belongs to: k, d, m, bwtsize, a
    CRC of strided counter rows, the '$' positions and the sentinel row. The
    same array as xla.py:1438-1457, so cache files serve both engines; of a
    device-resident index only those rows come to the host."""
    cfg = index.config
    stride = max(1, index.occ.shape[0] // 4096)
    head = [
        cfg.k,
        cfg.d,
        lut_m,
        index.bwtsize,
        zlib.crc32(np.ascontiguousarray(host_words(index.occ[::stride]))),
    ]
    return np.concatenate(
        [
            np.asarray(head, np.uint64),
            np.asarray(index.dollar_pos).astype(np.uint64),
            host_words(index.occ[-1]).astype(np.uint64),
        ]
    )


def lut_cache_path(path: str) -> str:
    """np.savez appends .npz; keep load and save on the same name."""
    return path if path.endswith(".npz") else path + ".npz"


def load_lut_cache(path: str, fingerprint: np.ndarray) -> np.ndarray | None:
    """The cached uint32 [4^m, 2] LUT at ``path`` if it exists and belongs to
    the index with ``fingerprint``; otherwise None (the caller rebuilds)."""
    path = lut_cache_path(path)
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        if "fingerprint" in z and np.array_equal(z["fingerprint"], fingerprint):
            return z["lut"]
    return None


def save_lut_cache(path: str, lut: np.ndarray, fingerprint: np.ndarray) -> None:
    """Persist a LUT of sane size (m=12 is 134 MB) in the JAX engine's format,
    written whole under another name first, so that processes writing and
    reading one cache at once (a multi-process mesh) never see a part."""
    if lut.nbytes <= LUT_CACHE_MAX_BYTES:
        path = lut_cache_path(path)
        tmp = f"{path}.{os.getpid()}.tmp.npz"
        np.savez(tmp, lut=lut, fingerprint=fingerprint)
        os.replace(tmp, path)
