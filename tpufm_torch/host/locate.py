"""Sampled-suffix-array locate tables on the host, and the numpy oracle.

Counterpart of tpufm/index/locate.py (``LocateIndex`` :35, ``build_locate``
:56, ``locate_oracle`` :99, ``_popcount_prefix`` :139, ``expand_intervals``
:147, ``locate_hits_compacted`` :160, ``locate_hits`` :178); the arrays are
bit-identical to tpufm's. Every BWT row p whose suffix start SA[p] is a
multiple of the sample rate s is marked, and the marked SA values are kept in
row order. Row p resolves by walking single-step LF until a marked row turns
up (at most s - 1 hops, since each hop moves the suffix start back by one):
SA[p] = samples[rank of the marked row] + hops.

The walk's LF table is a k=1 index over the same suffix array; the BWT
character at p is read from its two bit-planes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tpufm_torch.host.bitplanes import boundary_masks
from tpufm_torch.host.index import IndexConfig, KStepFMIndex, _pack_words, build_index, normalize_reference
from tpufm_torch.host.oracle import lf_step
from tpufm_torch.host.suffix_array import suffix_array

_U32 = np.uint32
_NONE = np.uint32(0xFFFFFFFF)


@dataclasses.dataclass
class LocateIndex:
    """The locate tables.

    lf1:         k=1 KStepFMIndex (the single-step LF mapping).
    sample_rate: s; every SA value divisible by s is sampled.
    mark_words:  uint32 [E+1, d/32]: bit 31 - p%32 of word (p%d)/32 of
                 block p//d is set iff BWT row p is sampled (MSB-first, the
                 bit-planes' packing); row E is zero.
    mark_rank:   uint32 [E+1]: sampled rows before each block.
    samples:     uint32 [n_sampled]: SA[p] of the sampled rows, in row order.
    """

    lf1: KStepFMIndex
    sample_rate: int
    mark_words: np.ndarray
    mark_rank: np.ndarray
    samples: np.ndarray


def build_locate(reference, sample_rate: int = 32, d: int = 128,
                 sa: np.ndarray | None = None, sa_method: str = "native") -> LocateIndex:
    """Locate tables of ``reference`` (see ``normalize_reference``); ``sa``
    its suffix array when already computed."""
    codes = normalize_reference(reference)
    bwtsize = int(codes.shape[0]) + 1
    if sa is None:
        sa = suffix_array(codes, sa_method)
    lf1 = build_index(codes, IndexConfig(k=1, d=d), sa=sa)
    E, nb = lf1.nentries, lf1.config.words_per_plane

    marked = (sa % sample_rate) == 0  # SA value 0 is always marked
    samples = sa[marked].astype(_U32)
    padded = np.zeros(E * d, dtype=np.uint8)
    padded[:bwtsize] = marked
    mark_words = np.zeros((E + 1, nb), dtype=_U32)
    mark_words[:E] = _pack_words(padded.reshape(E, nb, 32))
    mark_rank = np.zeros(E + 1, dtype=_U32)
    mark_rank[1:] = np.cumsum(padded.reshape(E, d).sum(axis=1, dtype=np.int64)).astype(_U32)
    return LocateIndex(lf1=lf1, sample_rate=sample_rate, mark_words=mark_words,
                       mark_rank=mark_rank, samples=samples)


def _popcount_prefix(words_rows: np.ndarray, off: np.ndarray, nb: int) -> np.ndarray:
    """Set bits strictly before in-block offset ``off`` of each [nb]-word row."""
    return np.bitwise_count(words_rows & boundary_masks(off, nb)).sum(axis=-1, dtype=np.int64)


def locate_oracle(loc: LocateIndex, positions) -> np.ndarray:
    """uint32 SA[p] of every BWT row p in ``positions`` (plain numpy: each
    hop is ``host.oracle.lf_step`` on the lanes still walking)."""
    lf1 = loc.lf1
    d, nb = lf1.config.d, lf1.config.words_per_plane
    p = np.asarray(positions, dtype=np.int64).copy()
    steps = np.zeros(p.shape, dtype=np.int64)
    out = np.full(p.shape, 0xFFFFFFFF, dtype=np.int64)
    done = np.zeros(p.shape, dtype=bool)
    for _ in range(loc.sample_rate):
        block, off = p // d, p % d
        word = loc.mark_words[block, off // 32]
        hit = ((word >> (31 - off % 32).astype(_U32)) & 1).astype(bool) & ~done
        if hit.any():
            pre = _popcount_prefix(loc.mark_words[block[hit]], off[hit], nb)
            rank = loc.mark_rank[block[hit]].astype(np.int64) + pre
            out[hit] = loc.samples[rank].astype(np.int64) + steps[hit]
            done |= hit
        if done.all():
            break
        act = ~done
        pb, po = block[act], off[act]
        sh = (31 - po % 32).astype(_U32)
        w0 = lf1.bitmaps[pb, 0, 0, po // 32]
        w1 = lf1.bitmaps[pb, 0, 1, po // 32]
        c = ((w0 >> sh) & 1) | (((w1 >> sh) & 1) << 1)
        p[act] = lf_step(lf1, p[act], c.astype(np.int64))
        steps[act] += 1
    return out.astype(_U32)


def expand_intervals(intervals: np.ndarray, max_hits: int):
    """uint32 [B, 2] -> (rows uint32 [B, max_hits], valid bool [B, max_hits]):
    the first max_hits BWT rows of each interval, 0 past its count."""
    intervals = np.asarray(intervals)
    lo = intervals[:, 0].astype(np.int64)
    width = (intervals[:, 1].astype(np.int64) - lo).clip(0, max_hits)
    cols = np.arange(max_hits, dtype=np.int64)[None, :]
    valid = cols < width[:, None]
    rows = np.where(valid, lo[:, None] + cols, 0).astype(_U32)
    return rows, valid


def locate_hits_compacted(locate_rows, intervals, max_hits: int) -> np.ndarray:
    """Expand the intervals, walk only the rows inside them through
    ``locate_rows`` (uint32 [N] -> uint32 [N]) and scatter the positions
    back, 0xFFFFFFFF past each interval's count. tpufm pads the walked rows
    to a 16K quantum to keep its compiled shapes few; nothing is compiled
    per shape here, so no row is padded."""
    rows, valid = expand_intervals(intervals, max_hits)
    pos = np.full(rows.shape, _NONE, dtype=_U32)
    if valid.any():
        pos[valid] = locate_rows(rows[valid])
    return pos


def locate_hits(loc: LocateIndex, intervals: np.ndarray, max_hits: int) -> np.ndarray:
    """uint32 [B, max_hits] text positions of the first max_hits rows of
    each search interval, 0xFFFFFFFF past its count (R - L)."""
    rows, valid = expand_intervals(intervals, max_hits)
    pos = locate_oracle(loc, rows.reshape(-1)).reshape(rows.shape)
    return np.where(valid, pos, _NONE).astype(_U32)
