"""One k-step LF round per interval end: the search's hot loop.

Counterpart of the Pallas kernel ``_lf_round_kernel`` / ``make_lf_round``
(tpufm/engine/pallas_kernel.py:41-141) and of ``lf_step_fused``
(tpufm/engine/xla.py:80-125). Contract, for every end j::

    block  = iv[j] // d
    row    = entries[min(block, E)]           (the row load, clamped as a
                                               JAX gather clamps)
    count  = popcount(prefix masks from iv[j] % d
                      & AND of the k plane pairs selected by code[j])
    count -= #levels i with block == dollar_block[i]
                          and code[j] == dollar_base[i] and iv[j] > dollar_pos[i]
    out[j] = (row[2k*nb + (code[j] mod 4^k)] + count) mod 2^32

which equals ``make_lf_round(k, d)(entries[iv // d], iv, code, dollar)``.
Intervals and codes are int64 tensors; table words are int32 tensors holding
uint32 bits; dollar is int64 [3, k] (rows pos, base, block).

Three entries, one round body (tpufm_torch/csrc/lf_round.cu); each takes
its plain PyTorch version for a CPU tensor and launches its kernel, or
raises, for a CUDA tensor:

* ``lf_round_pairs`` is what the engine runs: one read per thread, ``iv``
  int64 [B, 2] and one code per read for both ends, the row loaded once
  when both ends lie in one block. Plain version ``lf_round_pairs_reference``
  (the per-end round on ``iv.reshape(-1)`` and ``code.repeat_interleave(2)``).
* ``lf_round`` is the round per end on the fused table, ``make_lf_round(k,
  d)(entries[iv // d], iv, code, dollar)``, plain version
  ``lf_round_reference``. Unlike the Pallas design, the kernel loads its own
  rows: nothing forces the gathered rows through device memory between two
  launches on the GPU.
* ``lf_round_rows`` keeps the Pallas contract, ``make_lf_round(k, d)(rows,
  iv, code, dollar)``: row j was gathered beforehand (by ``row_gather``,
  K3, or by torch indexing) and may carry padding words past the 4^k
  counters. Plain version ``lf_round_rows_reference``. ``lf_round_indexed``
  is the round as ``PallasEngine`` splits it: torch's own indexing gathers,
  then ``lf_round_rows`` computes.
"""

from __future__ import annotations

import torch

from tpufm_torch.bitops import FULL, boundary_masks, from_u32_bits, match_words, popcount32

#: kernel launches made by ``lf_round`` in this process (plain-path calls on
#: CPU tensors do not count)
LAUNCHES = 0
#: kernel launches made by ``lf_round_rows`` in this process
ROWS_LAUNCHES = 0
#: kernel launches made by ``lf_round_pairs`` in this process
PAIRS_LAUNCHES = 0


def lf_round_rows_reference(rows, iv, code, dollar, k: int, d: int) -> torch.Tensor:
    """Plain PyTorch LF round on gathered rows (row j for end j; words past
    the 2k*nb plane words and 4^k counters are ignored), on any device:
    int64 [N] new interval ends."""
    nb = d // 32
    bmw = 2 * k * nb
    block = iv // d
    planes = from_u32_bits(rows[:, :bmw]).reshape(-1, k, 2, nb)
    cnt = from_u32_bits(rows.gather(1, (bmw + (code & (4**k - 1)))[:, None])[:, 0])
    matched = match_words(planes, code, k) & boundary_masks(iv % d, nb)
    count = popcount32(matched).sum(dim=-1)
    hit = (
        (block[:, None] == dollar[2])
        & (code[:, None] == dollar[1])
        & (iv[:, None] > dollar[0])
    )
    count = count - hit.sum(dim=-1)
    return (cnt + count) & FULL


def lf_round_reference(entries, iv, code, dollar, k: int, d: int) -> torch.Tensor:
    """Plain PyTorch LF round on any device: int64 [N] new interval ends."""
    row = (iv // d).clamp(max=entries.shape[0] - 1)
    return lf_round_rows_reference(entries[row], iv, code, dollar, k, d)


def lf_round_pairs_reference(entries, iv, code, dollar, k: int, d: int) -> torch.Tensor:
    """Plain PyTorch LF round of both ends of every read on any device:
    int64 [B, 2] new intervals of ``iv`` [B, 2] under one code per read."""
    return lf_round_reference(entries, iv.reshape(-1), code.repeat_interleave(2), dollar, k, d).view(-1, 2)


def _check(entries, iv, code, dollar, k: int, d: int, name: str = "entries", pairs: bool = False) -> None:
    if not 1 <= k <= 8:
        raise ValueError(f"k must be in [1, 8], got {k}")
    if d <= 0 or d % 32:
        raise ValueError(f"d must be a positive multiple of 32, got {d}")
    if entries.dtype != torch.int32 or entries.dim() != 2:
        raise ValueError(f"{name} must be int32 [rows, words], got {entries.dtype} {tuple(entries.shape)}")
    if entries.shape[1] < 2 * k * (d // 32) + 4**k:
        raise ValueError(
            f"rows of {entries.shape[1]} words cannot hold k={k} d={d} "
            f"({2 * k * (d // 32) + 4**k} words)"
        )
    if iv.dtype != torch.int64 or code.dtype != torch.int64 or dollar.dtype != torch.int64:
        raise ValueError("iv, code and dollar must be int64")
    want = "[N, 2] (both ends of a read)" if pairs else "[N] (one end per code)"
    if code.dim() != 1 or tuple(iv.shape) != (*code.shape, *((2,) if pairs else ())):
        raise ValueError(f"iv must be {want} and code [N], got {tuple(iv.shape)} and {tuple(code.shape)}")
    if tuple(dollar.shape) != (3, k):
        raise ValueError(f"dollar must be [3, {k}], got {tuple(dollar.shape)}")
    if not all(t.is_contiguous() for t in (entries, iv, code, dollar)):
        raise ValueError(f"{name}, iv, code and dollar must be contiguous")
    devices = {t.device for t in (entries, iv, code, dollar)}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devices))}")
    if iv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the LF round runs on cpu or cuda tensors, got {iv.device}")


def _launch(fn: str, table, iv, code, dollar, k: int, d: int, *shape) -> torch.Tensor:
    """Launch ``fn`` of the lf_round library on CUDA tensors; raises if the
    kernel cannot be built or launched."""
    from tpufm_torch import kernels

    lib = kernels.library("lf_round")
    out = torch.empty_like(iv)
    with torch.cuda.device(iv.device):
        stream = torch.cuda.current_stream(iv.device).cuda_stream
        err = getattr(lib, fn)(
            table.data_ptr(), *shape, table.shape[1], k, d // 32,
            iv.data_ptr(), code.data_ptr(), dollar.data_ptr(), out.data_ptr(),
            code.shape[0], stream,
        )
    if err:
        raise RuntimeError(f"{fn} kernel launch failed: {kernels.error_string('lf_round', err)}")
    return out


def lf_round(entries, iv, code, dollar, k: int, d: int) -> torch.Tensor:
    """LF round of every end in ``iv`` (see the module contract).

    CPU tensors take the plain version; CUDA tensors launch the kernel, and
    a kernel that cannot be built or launched raises."""
    _check(entries, iv, code, dollar, k, d)
    if iv.device.type == "cpu":
        return lf_round_reference(entries, iv, code, dollar, k, d)
    if iv.numel() == 0:
        return torch.empty_like(iv)
    global LAUNCHES
    out = _launch("tpufm_lf_round", entries, iv, code, dollar, k, d, entries.shape[0])
    LAUNCHES += 1
    return out


def lf_round_rows(rows, iv, code, dollar, k: int, d: int) -> torch.Tensor:
    """LF round of every end in ``iv`` on its gathered row ``rows[j]``
    (int32 [N, W], W >= 2k*nb + 4^k). CPU tensors take the plain version;
    CUDA tensors launch the kernel, and a kernel that cannot be built or
    launched raises."""
    _check(rows, iv, code, dollar, k, d, name="rows")
    if rows.shape[0] != iv.shape[0]:
        raise ValueError(f"{rows.shape[0]} rows for {iv.shape[0]} interval ends")
    if iv.device.type == "cpu":
        return lf_round_rows_reference(rows, iv, code, dollar, k, d)
    if iv.numel() == 0:
        return torch.empty_like(iv)
    global ROWS_LAUNCHES
    out = _launch("tpufm_lf_round_rows", rows, iv, code, dollar, k, d)
    ROWS_LAUNCHES += 1
    return out


def lf_round_pairs(entries, iv, code, dollar, k: int, d: int) -> torch.Tensor:
    """LF round of both ends of every read: ``iv`` int64 [B, 2] (lo, hi),
    ``code`` int64 [B], one code for both ends; int64 [B, 2]. CPU tensors
    take the plain version; CUDA tensors launch the kernel, one thread per
    read, and a kernel that cannot be built or launched raises."""
    _check(entries, iv, code, dollar, k, d, pairs=True)
    if iv.device.type == "cpu":
        return lf_round_pairs_reference(entries, iv, code, dollar, k, d)
    if iv.numel() == 0:
        return torch.empty_like(iv)
    global PAIRS_LAUNCHES
    out = _launch("tpufm_lf_round_pairs", entries, iv, code, dollar, k, d, entries.shape[0])
    PAIRS_LAUNCHES += 1
    return out


def lf_round_indexed(entries, iv, code, dollar, k: int, d: int) -> torch.Tensor:
    """The round as ``PallasEngine`` runs it (pallas_kernel.py:176-185):
    torch's own indexing gathers each end's row ``entries[min(iv // d, E)]``
    outside the kernel, then ``lf_round_rows`` computes on the rows."""
    rows = entries[(iv // d).clamp(max=entries.shape[0] - 1)]
    return lf_round_rows(rows, iv, code, dollar, k, d)
