"""Multi-device locate over a 1-D mesh (tpufm_torch.parallel.mesh).

Counterparts of tpufm/parallel/locate.py, bit-identical to its engines:

``DataParallelLocate`` (:39-98): the locate tables replicated on every shard
(small beside the search index), the batch of BWT rows split along the mesh;
each shard walks its part (K4) and the SA values are merged, 4 B a value,
every process getting the whole. A batch off the mesh multiple is padded with row 0, as tpufm pads
it, and the pad's values dropped.

``DataParallelSearchLocate`` (:101-365): both table sets replicated, the read
batch split; each shard runs the one-device engines on its part, on one
table set a device:
- ``search_locate``: reads to intervals and positions (``SearchLocateEngine``:
  K1, then K4 on the lanes inside each interval);
- ``locate_mismatch``: positions within Hamming distance 1 (the 3L+1
  variants through K1, then K4);
- ``locate_approx`` (``SeedExtendEngine``: K1, K4, K5) and ``locate_edits``
  (``EditExtendEngine``: K1, K4, K6): the text is passed with every call;
  the engines over it and its packed words are cached under tpufm's key (the
  kind, the distance, seed_hits, the text's shape and dtype and the CRC32 of
  all its bytes: a text edited between two calls builds a new entry), four
  entries at most.
Colocated shards (one device repeated) share one engine and one copy of the
tables and the packed text. A read batch off the mesh multiple is padded by
cycling its own reads (``pad_cycle``) and the pad's results dropped.

Every per-shard pass reads a count back to the host before its walk (the
boolean compaction of ``locate_compacted``). So a wave issues every shard's
search first (K1, no host read) and only then runs each shard's walk and
verify, so that a card's search is not held behind another card's read. On
colocated shards the order changes nothing.

Across processes (a mesh of ``initialize_distributed``) every process
passes the same batch and text, runs the shards it owns, and gets the whole
result from the merge; no other collective runs.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from tpufm_torch.engine.edit import EditExtendEngine
from tpufm_torch.engine.locate import LocateEngine, LocateTables, locate_tables_from_index
from tpufm_torch.engine.search import SearchEngine, mesh_wave, pad_cycle, stream_waves
from tpufm_torch.engine.search_locate import SearchLocateEngine
from tpufm_torch.engine.seed import SeedExtendEngine, hits_block, pack_text_words, split_hits
from tpufm_torch.engine.tables import Tables
from tpufm_torch.host.index import IndexConfig, KStepFMIndex
from tpufm_torch.host.locate import LocateIndex, locate_hits_compacted
from tpufm_torch.parallel.mesh import Mesh
from tpufm_torch.parallel.search import _merge, _per_device, _split


class DataParallelLocate:
    """Replicated-table, row-split locate over a 1-D mesh. ``walk`` of the
    methods: None runs K4; the plain ``locate_walk_reference`` replaces it."""

    #: rows a shard per wave (a whole wave is WAVE_PER_CHIP * mesh size)
    WAVE_PER_CHIP = 1 << 18

    def __init__(self, loc: LocateIndex | LocateTables, mesh: Mesh):
        tables = loc if isinstance(loc, LocateTables) else locate_tables_from_index(loc)
        self.mesh = mesh
        self.d, self.sample_rate, self.bwtsize = tables.d, tables.sample_rate, tables.bwtsize
        self.engines = _per_device(mesh.devices, lambda dev: LocateEngine(tables, dev))

    def place_rows(self, rows) -> list:
        """A uint32 [N] batch of BWT rows, N a mesh multiple, split along
        the mesh: one int64 tensor a shard, on its device."""
        rows = np.asarray(rows, dtype=np.uint32)
        n = self.mesh.size
        if rows.shape[0] % n:
            raise ValueError(f"batch {rows.shape[0]} not divisible by mesh size {n}; pad it")
        per = rows.shape[0] // n
        return [torch.from_numpy(rows[s * per:(s + 1) * per].astype(np.int64)).to(dev)
                for s, dev in zip(self.mesh.local_shards, self.mesh.devices)]

    def locate_device(self, parts: list, walk=None) -> torch.Tensor:
        """Per-shard rows (``place_rows``) -> int64 [N] SA values on the
        first shard's device, no host sync: the bench's entry."""
        return _merge([e.walk(p, walk) for e, p in zip(self.engines, parts)], self.mesh)

    def locate_rows(self, rows, wave: int | None = None, walk=None) -> np.ndarray:
        """uint32 [N] BWT rows -> uint32 [N] SA values, in waves of ``wave``
        rows (default WAVE_PER_CHIP * mesh size, rounded down to a mesh
        multiple). The batch is padded with row 0 (a valid row) to a mesh
        multiple, and past one wave to whole waves, as tpufm pads it."""
        rows = np.asarray(rows, dtype=np.uint32)
        N = rows.shape[0]
        n = self.mesh.size
        wave = max(n, mesh_wave(wave or self.WAVE_PER_CHIP * n, n))
        pad = -N % (wave if N > wave else n)
        if pad:
            rows = np.concatenate([rows, np.zeros(pad, np.uint32)])
        return stream_waves(rows, wave, lambda r: self.locate_device(self.place_rows(r), walk), None)[:N]

    def locate_hits(self, intervals, max_hits: int, walk=None) -> np.ndarray:
        """uint32 [B, 2] search intervals -> uint32 [B, max_hits] text
        positions of each interval's first max_hits rows, 0xFFFFFFFF past
        its count; only the rows inside an interval walk."""
        return locate_hits_compacted(lambda r: self.locate_rows(r, walk=walk), intervals, max_hits)


class DataParallelSearchLocate:
    """Search and locate in one pass, the read batch split over a 1-D mesh.

    index: a KStepFMIndex or ready ``Tables``; loc: a LocateIndex or
    ``LocateTables`` over the same text. lut_m > 0 starts every read from
    the m-mer prefix LUT, loaded from ``lut_cache`` or built once on the
    first shard's device, and copied to the others. ``step``, ``walk`` and
    ``verify`` of the methods: None runs the kernels; the plain versions
    replace them."""

    #: reads a shard per wave: each read carries max_hits walk lanes
    WAVE_PER_CHIP = 1 << 15

    def __init__(self, index: KStepFMIndex | Tables, loc: LocateIndex | LocateTables, mesh: Mesh,
                 max_hits: int = 4, lut_m: int = 0, lut_cache: str | None = None):
        k, d = (index.k, index.d) if isinstance(index, Tables) else (index.config.k, index.config.d)
        if lut_m and lut_m % k:
            raise ValueError(f"lut_m={lut_m} must be a multiple of k={k}")
        self.mesh = mesh
        self.config = IndexConfig(k=k, d=d)
        self.k, self.d = k, d
        self.max_hits = max_hits
        if not isinstance(loc, LocateTables):
            loc = locate_tables_from_index(loc)
        first = []

        def make(dev):
            if first:  # the LUT is built (or loaded) once, then copied
                eng, src = SearchLocateEngine(index, loc, dev, max_hits=max_hits), first[0].search_engine
                if src.lut_m and eng.search_engine.lut is None:
                    eng.search_engine.lut, eng.search_engine.lut_m = src.lut.to(dev), src.lut_m
                return eng
            first.append(SearchLocateEngine(index, loc, dev, max_hits=max_hits, lut_m=lut_m, lut_cache=lut_cache))
            return first[0]

        self.engines = _per_device(mesh.devices, make)
        self.bwtsize, self.lut_m = self.engines[0].search_engine.bwtsize, self.engines[0].search_engine.lut_m
        self._approx_cache = {}

    def _prepared(self, queries) -> tuple:
        """(reads padded by cycling to a mesh multiple, B)."""
        queries = np.asarray(queries, np.uint8)
        return pad_cycle(queries, -queries.shape[0] % self.mesh.size), queries.shape[0]

    def _wave(self, wave: int | None, per_chip: int) -> int:
        n = self.mesh.size
        return max(n, mesh_wave(wave or per_chip * n, n))

    def search_locate_device(self, parts: list, step=None, walk=None) -> torch.Tensor:
        """Per-shard reads (one uint8 [b, L] tensor a shard on its device)
        -> int64 [B, 2 + max_hits] on the first shard's device: each read's
        interval, then the positions of its first max_hits rows."""
        ivs = [e.search_engine.search_device(q, step) for e, q in zip(self.engines, parts)]
        return _merge([e.locate_intervals_device(iv, walk) for e, iv in zip(self.engines, ivs)], self.mesh)

    def search_locate(self, queries, wave: int | None = None, step=None, walk=None):
        """uint8 [B, L] -> (intervals uint32 [B, 2], positions uint32 [B,
        max_hits], 0xFFFFFFFF past each interval's count), in waves of
        ``wave`` reads (default WAVE_PER_CHIP * mesh size)."""
        mh = self.max_hits
        queries, B = self._prepared(queries)
        if B == 0:
            return np.zeros((0, 2), np.uint32), np.zeros((0, mh), np.uint32)
        out = stream_waves(queries, self._wave(wave, self.WAVE_PER_CHIP),
                           lambda q: self.search_locate_device(_split(q, self.mesh), step, walk), None,
                           (2 + mh,))[:B]
        return np.ascontiguousarray(out[:, :2]), np.ascontiguousarray(out[:, 2:])

    def locate_mismatch(self, queries, wave: int | None = None, step=None, walk=None) -> np.ndarray:
        """uint8 [B, L] -> uint32 [B, max_hits] positions within Hamming
        distance 1, 0xFFFFFFFF padded (``SearchLocateEngine.
        locate_mismatch`` on each shard's part), in waves of ``wave`` reads,
        by default max(1, 2^20 // (3L + 1)) a shard."""
        queries, B = self._prepared(queries)
        if B == 0:
            return np.zeros((0, self.max_hits), np.uint32)
        per_chip = max(1, SearchEngine.WAVE // (3 * queries.shape[1] + 1))

        def run(q):
            parts = _split(q, self.mesh)
            ivs = [e.search_variants_device(p, step) for e, p in zip(self.engines, parts)]
            return _merge([e.locate_variants_device(iv, p.shape[0], walk)
                           for e, iv, p in zip(self.engines, ivs, parts)], self.mesh)

        return stream_waves(queries, self._wave(wave, per_chip), run, None, (self.max_hits,))[:B]

    def _approx_run(self, queries, text, key: tuple, engine_cls, make, locate, wave, step):
        """The body of ``locate_approx`` and ``locate_edits``: the engines
        of ``key`` and ``text`` (one a device, ``make(source, words)`` over
        that device's ``SearchLocateEngine`` and the packed text, cached;
        colocated shards share one), then the batch split and streamed in
        waves of ``engine_cls.WAVE`` a shard, each wave issuing every
        shard's seed search before any shard's walk. (positions, counts,
        overflow) as the one-device engine's."""
        text = np.asarray(text)
        key = key + (text.shape, text.dtype.str, zlib.crc32(memoryview(np.ascontiguousarray(text))))
        engines = self._approx_cache.get(key)
        if engines is None:
            if len(self._approx_cache) >= 4:
                self._approx_cache.clear()
            words = text if text.dtype == np.uint32 else pack_text_words(text)
            source = dict(zip(self.mesh.devices, self.engines))
            engines = self._approx_cache[key] = _per_device(self.mesh.devices, lambda dev: make(source[dev], words))
        mh = self.max_hits
        queries, B = self._prepared(queries)
        if B == 0:
            return np.zeros((0, mh), np.uint32), np.zeros(0, np.uint32), np.zeros(0, bool)

        def run(q):
            parts = _split(q, self.mesh)
            seeds = [e.seeds(p, step) for e, p in zip(engines, parts)]
            return _merge([hits_block(*locate(e, p, s)) for e, p, s in zip(engines, parts, seeds)], self.mesh)

        out = stream_waves(queries, self._wave(wave, engine_cls.WAVE), run, None, (mh + 2,))[:B]
        return split_hits(out, mh)

    def locate_approx(self, queries, text, mismatches: int, seed_hits: int = 32, wave: int | None = None,
                      step=None, walk=None, verify=None):
        """Seed-and-extend positions within Hamming distance ``mismatches``
        of ``text`` (2-bit codes, or its packed words), each shard running a
        ``SeedExtendEngine`` on its part: (positions uint32 [B, max_hits]
        ascending, 0xFFFFFFFF padded; counts uint32 [B]; overflow bool [B])."""
        return self._approx_run(
            queries, text, ("hamming", mismatches, seed_hits), SeedExtendEngine,
            lambda src, words: SeedExtendEngine(src, None, words, mismatches=mismatches, seed_hits=seed_hits,
                                                max_hits=self.max_hits, device=src.device),
            lambda e, q, s: e.locate_approx_device(q, walk=walk, verify=verify, seeds=s),
            wave, step)

    def locate_edits(self, queries, text, edits: int, seed_hits: int = 32, wave: int | None = None,
                     step=None, walk=None, verify=None):
        """Edit-distance alignment sites within ``edits`` of ``text``, each
        shard running an ``EditExtendEngine`` on its part: (starts uint32
        [B, max_hits] ascending, 0xFFFFFFFF padded; counts uint32 [B];
        overflow bool [B])."""
        return self._approx_run(
            queries, text, ("edits", edits, seed_hits), EditExtendEngine,
            lambda src, words: EditExtendEngine(src, None, words, edits=edits, seed_hits=seed_hits,
                                                max_hits=self.max_hits, device=src.device),
            lambda e, q, s: e.locate_edits_device(q, walk=walk, verify=verify, seeds=s),
            wave, step)
