"""Index layout transforms: the bitmap interleave (tags 101, 201) and the
alternate-counters table (tags 200, 201) that ``transform`` writes.

Counterpart of tpufm/index/layouts.py (``interleave_bitmap_words`` :57,
``deinterleave_bitmap_words`` :67, ``make_alt_counters`` :72).

* Interleave: bitmap words regrouped from (level, plane, window) order to
  (window, level, plane) order, so one 16-byte vector holds all 2k planes
  of a 32-position window (the reference's transformIndexBitmaps.c:269-295).
* Alternate counters: entry e stores counters [0, 4^k/2) when e is even and
  [4^k/2, 4^k) when e is odd; one entry is appended holding the end-of-text
  counts, so that odd lookups read the next entry and count backwards (the
  reference's transformIndexAlternateCounters.c:434-479).
"""

from __future__ import annotations

import numpy as np

from tpufm_torch.host.bitplanes import block_kmer_counts
from tpufm_torch.host.index import AltCountersIndex, KStepFMIndex


def interleave_bitmap_words(bitmaps: np.ndarray) -> np.ndarray:
    """[..., k, 2, nb] -> [..., nb, k, 2] word order (tag 101/201 packing):
    flattened, new[(2k)*w + 2s + p] = old[(2*nb)*s + nb*p + w]."""
    return np.moveaxis(bitmaps, -1, -3)


def deinterleave_bitmap_words(bitmaps_il: np.ndarray) -> np.ndarray:
    """Inverse of interleave_bitmap_words: [..., nb, k, 2] -> [..., k, 2, nb]."""
    return np.moveaxis(bitmaps_il, -3, -1)


def make_alt_counters(index: KStepFMIndex, reference_semantics: bool = False) -> AltCountersIndex:
    """The alternate-counters table of ``index``: occ_slim uint32
    [nentries + 2, 4^k / 2], the stored counter half of each real entry,
    then the appended end-of-text entry, then a safety row.

    reference_semantics=False: the appended entry is '$'-exclusive (the
    sentinel's counts plus the padding's 'A' k-mers), so an
    alternate-counters search equals the baseline search everywhere.

    reference_semantics=True (the .fmi images, byte-identical to the
    reference's transform): the appended entry is the previous entry plus a
    recount of the final block's bit-planes, in which a '$' counts as its
    ``dollar_base`` k-mer and the padding as 'A' (the reference's
    transformIndexAlternateCounters.c:467-478).

    The safety row is reached only when bwtsize % d == 0 and the first
    R = bwtsize lookup needs the other counter half: the true end-of-text
    counts, plus d for k-mer 0 where the backward count runs over the
    complement of an all-zero bitmap row.
    """
    cfg = index.config
    S, d = cfg.num_slim_counters, cfg.d
    n_old = index.nentries
    bwtsize = index.bwtsize

    occ_slim = np.zeros((n_old + 2, S), dtype=np.uint32)
    odd = (np.arange(n_old) % 2).astype(bool)
    occ_slim[:n_old] = np.where(odd[:, None], index.occ[:n_old, S:2 * S], index.occ[:n_old, :S])

    m = bwtsize % d
    half = S if n_old % 2 else 0
    if reference_semantics:
        block = bwtsize // d
        last_cnt = block_kmer_counts(index.bitmaps[block:block + 1], cfg.k, prefix=m)[0]
        last_cnt[0] += d - m
        occ_slim[n_old] = index.occ[n_old - 1, half:half + S] + last_cnt[half:half + S].astype(np.uint32)
    else:
        appended = index.occ[n_old, half:half + S].astype(np.uint32).copy()
        if m and half == 0:
            appended[0] += np.uint32(d - m)
        occ_slim[n_old] = appended

    half2 = S if (n_old + 1) % 2 else 0
    safety = index.occ[n_old, half2:half2 + S].astype(np.uint32).copy()
    if half2 == 0:
        safety[0] += np.uint32(d)
    occ_slim[n_old + 1] = safety
    return AltCountersIndex(base=index, occ_slim=occ_slim)
