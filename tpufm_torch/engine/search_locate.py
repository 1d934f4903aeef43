"""Reads to text positions in one device pass: exact and Hamming <= 1.

Counterparts of ``make_search_locate_fn`` (tpufm/engine/xla.py:1163),
``make_mismatch_locate_fn`` (:1202) and ``SearchLocateEngine`` (:1255-1349).
The search runs on a ``SearchEngine`` whose k=1 tail table is the fused
locate rows themselves (xla.py:1183-1189: the LF round ignores their mark
columns), so any read length works at no table cost. Each read's interval
expands on the device to its first max_hits BWT rows (``lo + j``, the order
of ``expand_intervals``), and only the rows inside the interval walk (K4).
The positions follow BWT row order, not text order, as tpufm's do.
"""

from __future__ import annotations

import numpy as np
import torch

from tpufm_torch.bitops import FULL
from tpufm_torch.engine.locate import LocateEngine, LocateTables, locate_compacted
from tpufm_torch.engine.mismatch import variants1
from tpufm_torch.engine.search import SearchEngine, stream_waves
from tpufm_torch.engine.tables import Tables
from tpufm_torch.host.index import KStepFMIndex
from tpufm_torch.host.locate import LocateIndex


class SearchLocateEngine(torch.nn.Module):
    """Search + locate on one device.

    index: a KStepFMIndex or ready ``Tables`` (an AltCountersIndex raises
    tpufm's ValueError: the search is the fused layout's); loc: a LocateIndex or ``LocateTables`` over the
    same text. lut_m > 0 starts every read from the m-mer prefix LUT,
    loaded from ``lut_cache`` (as ``SearchEngine``'s) or built on the device
    unless ``index`` brings one. ``step`` and ``walk`` of the
    methods: None runs this engine's kernels (K1, K4); the plain
    ``lf_round_reference`` and ``locate_walk_reference`` replace them.
    """

    #: reads per wave of ``search_locate``: each read carries max_hits walk
    #: lanes (the JAX engine's wave; not tuned here)
    WAVE = 1 << 18

    def __init__(
        self,
        index: KStepFMIndex | Tables,
        loc: LocateIndex | LocateTables,
        device: str | torch.device,
        max_hits: int = 4,
        lut_m: int = 0,
        lut_cache: str | None = None,
    ):
        super().__init__()
        if max_hits < 1:
            raise ValueError(f"max_hits must be >= 1, got {max_hits}")
        self.max_hits = max_hits
        self.search_engine = SearchEngine(index, device, lut_m=lut_m, lut_cache=lut_cache, layout="fused")
        self.locate_engine = LocateEngine(loc, self.search_engine.device)
        if self.locate_engine.bwtsize != self.search_engine.bwtsize:
            raise ValueError(
                f"locate tables of bwtsize {self.locate_engine.bwtsize} for an index of "
                f"bwtsize {self.search_engine.bwtsize} (different texts?)"
            )
        loc_e = self.locate_engine
        self.search_engine.use_tail(loc_e.rows, loc_e.dollar, loc_e.d)

    @property
    def device(self) -> torch.device:
        return self.search_engine.device

    def _expand(self, iv: torch.Tensor):
        """int64 [..., 2] intervals -> (rows, valid) [..., max_hits]: the
        first max_hits rows lo + j of each interval, 0 past its width (the
        width taken mod 2^32, as the JAX engine's uint32 subtraction)."""
        lo = iv[..., 0]
        width = ((iv[..., 1] - lo) & FULL).clamp(max=self.max_hits)
        cols = torch.arange(self.max_hits, device=iv.device)
        valid = cols < width[..., None]
        return torch.where(valid, lo[..., None] + cols, 0), valid

    def _walk_valid(self, rows, valid, walk):
        pos = locate_compacted(lambda p: self.locate_engine.walk(p, walk), rows, valid)
        return torch.where(valid, pos, FULL)

    def locate_intervals_device(self, iv: torch.Tensor, walk=None) -> torch.Tensor:
        """int64 [B, 2] intervals on this engine's device -> int64 [B, 2 +
        max_hits]: each interval, then the text positions of its first
        max_hits rows, 0xFFFFFFFF past its count. Reads the count of rows
        to walk back to the host."""
        rows, valid = self._expand(iv)
        return torch.cat([iv, self._walk_valid(rows, valid, walk)], dim=1)

    def search_locate_device(self, queries: torch.Tensor, step=None, walk=None) -> torch.Tensor:
        """uint8 [B, L] reads on this engine's device -> int64 [B, 2 +
        max_hits]: each read's interval, then the text positions of its
        first max_hits rows, 0xFFFFFFFF past its count."""
        return self.locate_intervals_device(self.search_engine.search_device(queries, step), walk)

    def search_locate(self, queries, wave: int | None = None, step=None, walk=None):
        """uint8 [B, L] host reads -> (uint32 [B, 2] intervals, uint32 [B,
        max_hits] positions, 0xFFFFFFFF past each interval's count), in
        waves of ``wave`` reads; both ride one [wave, 2 + max_hits] block."""
        queries = np.require(queries, np.uint8, ["C", "W"])
        out = stream_waves(queries, wave or self.WAVE, lambda q: self.search_locate_device(q, step, walk),
                           self.device, (2 + self.max_hits,))
        return np.ascontiguousarray(out[:, :2]), np.ascontiguousarray(out[:, 2:])

    def search_variants_device(self, queries: torch.Tensor, step=None) -> torch.Tensor:
        """uint8 [W, L] reads on this engine's device -> int64 [W * (3L+1),
        2]: the intervals of every read's Hamming <= 1 variants."""
        return self.search_engine.search_device(variants1(queries).reshape(-1, queries.shape[1]), step)

    def locate_variants_device(self, iv: torch.Tensor, W: int, walk=None) -> torch.Tensor:
        """The variants' intervals of W reads (``search_variants_device``)
        -> int64 [W, max_hits] positions, 0xFFFFFFFF padded: the first
        max_hits candidate rows of each read in (variant, row) order
        (xla.py:1202-1252). Only those walk."""
        mh = self.max_hits
        rows, valid = self._expand(iv.view(W, iv.shape[0] // max(W, 1), 2))
        rows, valid = rows.reshape(W, -1), valid.reshape(W, -1)
        # kept candidates go to columns 0..mh-1 in order; overflow and invalid
        # lanes to the discarded column mh. That column takes duplicate
        # indices, which scatter_ resolves in no fixed order on CUDA; it is
        # dropped, so the kept columns do not depend on it.
        slot = valid.cumsum(dim=1) - 1
        slot = torch.where(valid & (slot < mh), slot, mh)
        kept = torch.zeros((W, mh + 1), dtype=rows.dtype, device=rows.device).scatter_(1, slot, rows)
        nkept = valid.sum(dim=1).clamp(max=mh)
        keep = torch.arange(mh, device=rows.device) < nkept[:, None]
        return self._walk_valid(kept[:, :mh], keep, walk)

    def locate_mismatch_device(self, queries: torch.Tensor, step=None, walk=None) -> torch.Tensor:
        """uint8 [W, L] reads on this engine's device -> int64 [W, max_hits]
        positions of occurrences within Hamming distance 1, 0xFFFFFFFF
        padded (``locate_variants_device``)."""
        return self.locate_variants_device(self.search_variants_device(queries, step), queries.shape[0], walk)

    def locate_mismatch(self, queries, wave: int | None = None, step=None, walk=None) -> np.ndarray:
        """uint8 [B, L] host reads -> uint32 [B, max_hits] positions within
        Hamming distance 1 (``locate_mismatch_device``), in waves of
        ``wave`` reads, by default SearchEngine.WAVE // (3L + 1): a read is
        3L+1 search lanes."""
        queries = np.require(queries, np.uint8, ["C", "W"])
        wave = wave or max(1, SearchEngine.WAVE // (3 * queries.shape[1] + 1))
        return stream_waves(queries, wave, lambda q: self.locate_mismatch_device(q, step, walk),
                            self.device, (self.max_hits,))
