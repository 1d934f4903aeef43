"""The (k, d, LUT) a reference of a given size is built and searched with.

Counterpart of ``recommend_config`` (tpufm/config.py:134) with its three
boundaries (:117, :125, :131), copied unchanged so that both packages pick
the same configuration for the same reference: ``build --auto`` and the
genome bench record use it. The ladder was measured on a TPU v5e (its
memory-space and capacity limits set every boundary below) and has not been
re-derived for the H100; that is a cell of the port's bench still to run
(ROADMAP, Queue 1).
"""

from __future__ import annotations

#: entries of the largest table the TPU ladder treats as its fast path
#: (tpufm/config.py:117)
VMEM_FAST_ENTRIES = 210_000

#: largest reference (bases) the TPU ladder keeps at d=192 before it moves to
#: d=320 (tpufm/config.py:125)
HBM_MAX_D192_BASES = 2_400_000_000

#: largest reference (bases) beside which the TPU ladder allows the 15-mer
#: LUT (tpufm/config.py:131)
LUT15_MAX_BASES = 1_000_000_000


def recommend_config(refsize: int, query_len: int = 120, serving: bool = False) -> dict:
    """{'k', 'd', 'lut_m'} for a reference of ``refsize`` bases and reads of
    ``query_len``, exactly as tpufm's ``recommend_config`` gives them.

    k: the first of 3, 2, 1 that divides ``query_len``. d: 192 if the table
    has at most ``VMEM_FAST_ENTRIES`` entries at d=192, else 320 if it has
    at most that many at d=320, else 192 up to ``HBM_MAX_D192_BASES`` + 1
    rows and 320 past it. lut_m: the largest m <= 12 that k divides, for
    reads of 24 bases or more (else 0); with ``serving``, 15 where k divides
    15, reads have 30 bases or more and the reference has at most
    ``LUT15_MAX_BASES``.
    """
    k = next((kk for kk in (3, 2, 1) if query_len % kk == 0), 1)
    bwtsize = refsize + 1
    d = next(
        (dd for dd in (192, 320) if -(-bwtsize // dd) <= VMEM_FAST_ENTRIES),
        192 if bwtsize <= HBM_MAX_D192_BASES else 320,
    )
    lut_m = 0
    if query_len >= 24:
        lut_m = 12 - (12 % k)
    if serving and query_len >= 30 and 15 % k == 0 and refsize <= LUT15_MAX_BASES:
        lut_m = 15
    return {"k": k, "d": d, "lut_m": lut_m}
