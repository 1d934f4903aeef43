"""Hamming distance <= 1 as ordinary search lanes.

Counterpart of ``_variants1`` (tpufm/engine/xla.py:926): every read fans out
to itself and its 3L single-base substitutions, built on the device, and the
3L+1 patterns ride one batched search. The patterns of a read are pairwise
distinct strings, so their SA intervals are disjoint: their widths sum to
the exact count of occurrences within Hamming distance 1, and no text
position is reported twice.
"""

from __future__ import annotations

import torch


def variants1(queries: torch.Tensor) -> torch.Tensor:
    """uint8 [W, L] -> uint8 [W, 3L+1, L]: each read, then its substitution
    at position i by offset o (code + o mod 4) as variant 1 + 3i + (o - 1),
    for i in [0, L) and o in 1..3 (the order of xla.py:926-941)."""
    W, L = queries.shape
    dev = queries.device
    base = queries[:, None, None, :]  # [W, 1, 1, L]
    at = torch.arange(L, device=dev)
    hit = at[None, :, None, None] == at[None, None, None, :]  # [1, L, 1, L]: column == position
    off = torch.arange(1, 4, dtype=torch.uint8, device=dev)[None, None, :, None]
    sub = (base + off) & 3  # [W, 1, 3, L]
    v = torch.where(hit, sub, base)  # [W, L, 3, L]
    return torch.cat([queries[:, None, :], v.reshape(W, 3 * L, L)], dim=1)
