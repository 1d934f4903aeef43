"""Suffix array of a text on the device: prefix doubling.

Counterpart of tpufm/index/sa_device.py (``initial`` :44, ``step`` :66,
``suffix_array_device_arr`` :99, ``suffix_array_device`` :134):
Manber-Myers prefix doubling, every round one device-wide stable sort plus
a rank recompression (the flags of changed keys, their cumulative sum and a
scatter), with one scalar read by the host a round for the early exit.

The first key packs 10 symbols (symbol + 1 in 3 bits each, 0 past the end)
into 30 bits, so a random DNA text needs two or three doubling rounds after
the first sort (h: 10 -> 20 -> 40); a repetitive text takes up to
ceil(log2(n / 10)) rounds.

Torch has no stable sort on two keys. A round sorts one int64 key,
``rank[i] << 32 | second[i]`` with ``second[i] = rank[i + h] + 1`` and 0
past the end (a suffix whose 2h-prefix runs off the text sorts first among
equal h-prefixes), with ``torch.sort(stable=True)``, the counterpart of the
``lax.sort`` that tpufm's rounds run (XLA's sort, not a Pallas kernel).
Ranks are below n + 1, so the key needs n + 1 < 2^31
(``MAX_DEVICE_BASES`` keeps under that). Keys that tie leave the ranks
unchanged, and once the ranks are distinct the order is unique: the suffix
array of a text with a unique sentinel.

Ranks are int32 and the finished suffix array is int32 (values 0..n). A
round holds the int64 key, the sort's int64 values and indices and the
sort's own buffers at once; ``MAX_DEVICE_BASES`` follows from the peak that
chip_smoke.py measures on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from tpufm_torch.device import resolve_device

#: the largest text the device build takes: the build's peak device memory,
#: 49.23 bytes a base (chip_smoke.py phase 16, 250 Mbase, NVIDIA H100 80GB
#: HBM3), into 90% of the card's 85,017,493,504 bytes, rounded down to 10
#: Mbase; below the 2^31 - 2 that the sort key allows
MAX_DEVICE_BASES = 1_550_000_000

#: symbols a first key packs (3 bits each)
PACK = 10


def check_size(n: int) -> None:
    """Raise for a text of ``n`` bases past ``MAX_DEVICE_BASES``."""
    if n > MAX_DEVICE_BASES:
        raise ValueError(
            f"text of {n} bases exceeds the device suffix array limit "
            f"({MAX_DEVICE_BASES}); build on the host (method='native')"
        )


def _recompress(skey: torch.Tensor, order: torch.Tensor):
    """Sorted keys and their order -> (rank int32 [big] of every position,
    order, distinct as a 0-d bool tensor): equal neighbouring keys share a
    rank, and ranks count the changes."""
    big = skey.shape[0]
    changed = skey[1:] != skey[:-1]
    skey.set_()  # release the sorted keys before the ranks are allocated
    rank_sorted = torch.zeros(big, dtype=torch.int32, device=order.device)
    torch.cumsum(changed, 0, dtype=torch.int32, out=rank_sorted[1:])
    del changed
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)
    return rank, order, rank_sorted[-1] == big - 1


def initial(codes: torch.Tensor):
    """uint8 [n] text on its device -> (rank int32 [n+1] over PACK-symbol
    prefixes, order int64 [n+1], distinct): the first sort."""
    n = codes.shape[0]
    big = n + 1
    t = torch.zeros(big + PACK - 1, dtype=torch.int32, device=codes.device)
    t[:n] = codes
    t[:n] += 1  # the sentinel and the padding past it stay 0
    key = torch.zeros(big, dtype=torch.int32, device=codes.device)
    for j in range(PACK):
        key <<= 3
        key |= t[j:j + big]
    del t
    skey, order = torch.sort(key, stable=True)
    del key
    return _recompress(skey, order)


def step(rank: torch.Tensor, h: int):
    """One doubling round: rank over h-prefixes -> rank over 2h-prefixes
    (and the order, and whether the ranks are distinct). ``rank`` is
    consumed: once the key holds it, its storage is released (the tensor is
    left empty), so that the sort's peak does not hold it too."""
    big = rank.shape[0]
    key = rank.to(torch.int64) << 32
    if h < big:
        tail = key[:big - h]
        tail += rank[h:]  # the low 32 bits are 0: this sets second - 1
        tail += 1
    rank.set_()
    skey, order = torch.sort(key, stable=True)
    del key
    return _recompress(skey, order)


def upload_text(codes: np.ndarray, device: str | torch.device) -> torch.Tensor:
    """A host text as a uint8 tensor on ``device`` (checked usable; the
    array is copied first only when torch cannot take it as it is)."""
    codes = np.require(codes, np.uint8, ["C", "W"])
    return torch.from_numpy(codes).to(resolve_device(device))


def suffix_array_device_arr(codes: torch.Tensor) -> torch.Tensor:
    """Suffix array of a text on its device: uint8 [n] with symbols in
    [0, 6] -> int32 [n+1] on the same device (the device builders take it
    as it lies). Symbols are not checked here (``suffix_array_device``
    checks a host text; the builders see 2-bit codes)."""
    if codes.dtype != torch.uint8 or codes.dim() != 1:
        raise ValueError(f"codes must be uint8 [n], got {codes.dtype} {tuple(codes.shape)}")
    n = codes.shape[0]
    check_size(n)
    if n == 0:
        return torch.zeros(1, dtype=torch.int32, device=codes.device)
    rank, order, distinct = initial(codes)
    h = PACK
    # ceil(log2((n + 1) / PACK)) rounds at most: once 2h >= n + 1 every
    # prefix holds the sentinel, so the ranks are distinct
    while not bool(distinct) and h < n + 1:
        del order
        rank, order, distinct = step(rank, h)
        h *= 2
    del rank
    return order.to(torch.int32)


def suffix_array_device(codes: np.ndarray, device: str | torch.device = "cuda") -> np.ndarray:
    """Suffix array of ``codes`` + sentinel, sorted on ``device``: int64
    [n+1] with result[0] == n, as ``host.suffix_array.suffix_array``."""
    codes = np.asarray(codes, dtype=np.uint8)
    if codes.shape[0] == 0:
        return np.zeros(1, dtype=np.int64)
    if int(codes.max()) > 6:
        # the first key packs symbol + 1 into 3 bits; a larger symbol would
        # spill into its neighbour's bits
        raise ValueError(
            "device suffix array supports symbols in [0, 6] "
            f"(got max {int(codes.max())}); use method='native'/'doubling'"
        )
    check_size(codes.shape[0])
    return suffix_array_device_arr(upload_text(codes, device)).cpu().numpy().astype(np.int64)
