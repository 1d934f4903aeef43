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

The other layouts' rounds, one read per thread, both ends under one code,
``iv`` int64 [B, 2] -> int64 [B, 2]:

* ``lf_round_paired`` (K1's fourth entry, lf_round.cu; ``lf_step_paired``,
  xla.py:128-176): one row-pair load at lo's block from the paired table
  ``entries_paired`` (row i = fused rows i and i+1, each ``W`` words, the
  row stride 2W); hi takes the second half where its block is lo's + 1,
  else the first. Returns the intervals and ``ok`` = (hi's block - lo's
  block, mod 2^32) <= 1; where it is False, hi is computed on the wrong row
  (as in tpufm) and the engine searches the read again on the fused path.
  Plain version ``lf_round_paired_reference``.
* ``lf_round_split`` (K8, lf_round_split.cu; ``lf_step_split``,
  xla.py:179-212): the plane words from ``bitmaps[block]`` [E+1, 2k*nb],
  the counter from ``occ[block, code]`` [E+1, 4^k], both clamped; the '$'
  correction as K1's. Plain version ``lf_round_split_reference``.
* ``lf_round_ac`` (K8; ``lf_step_ac``, xla.py:215-244, the numpy oracle
  tpufm/engine/oracle.py:63-105): the alternate counters ``occ_slim``
  [E+2, S], S = 4^k / 2. Per end, ``back = (block odd) XOR (code >= S)``;
  the counter is ``occ_slim[block + back, code & (S-1)]``; where ``back``,
  the popcount runs over the block past the end (the complemented prefix
  masks), the '$' correction counts levels with ``iv <= dollar_pos``, and
  the result is counter MINUS count, else counter plus count (mod 2^32).
  Plain version ``lf_round_ac_reference``.

K9, ``lf_answer_owned`` (lf_round_split.cu; ``_answer_owned``,
tpufm/parallel/search.py:267-290): the sharded-index engine's answer on one
shard of the split tables. A request (block, code, interval), uint32 each
(int32 [N, 3] rows), belongs to shard block // e_local; the shard answers
its own from its local row block - shard * e_local, as the split round's
per end (counter + popcount - '$' hits, the '$' levels compared on the
global block), and 0 for the rest. Plain version
``lf_answer_owned_reference``.
"""

from __future__ import annotations

import torch

from tpufm_torch.bitops import FULL, boundary_masks, from_u32_bits, match_words, popcount32, to_u32_bits

#: kernel launches made by ``lf_round`` in this process (plain-path calls on
#: CPU tensors do not count)
LAUNCHES = 0
#: kernel launches made by ``lf_round_rows`` in this process
ROWS_LAUNCHES = 0
#: kernel launches made by ``lf_round_pairs`` in this process
PAIRS_LAUNCHES = 0
#: kernel launches made by ``lf_round_paired`` in this process
PAIRED_LAUNCHES = 0
#: kernel launches made by ``lf_round_split`` in this process
SPLIT_LAUNCHES = 0
#: kernel launches made by ``lf_round_ac`` in this process
AC_LAUNCHES = 0
#: kernel launches made by ``lf_answer_owned`` (K9) in this process
OWNED_LAUNCHES = 0


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


def lf_round_paired_reference(entries_paired, iv, code, dollar, k: int, d: int):
    """Plain PyTorch paired round on any device: (int64 [B, 2] new
    intervals, bool [B] ok) of ``iv`` [B, 2] under one code per read, on the
    paired table int32 [E+1, 2W] (see the module docstring)."""
    W = entries_paired.shape[1] // 2
    block = iv // d
    prow = entries_paired[block[:, 0].clamp(max=entries_paired.shape[0] - 1)]
    delta = (block[:, 1] - block[:, 0]) & FULL
    hi_row = torch.where((delta == 1)[:, None], prow[:, W:], prow[:, :W])
    rows = torch.stack([prow[:, :W], hi_row], dim=1).reshape(-1, W)
    out = lf_round_rows_reference(rows, iv.reshape(-1), code.repeat_interleave(2), dollar, k, d)
    return out.view(-1, 2), delta <= 1


def _plane_matches(bitmaps, rows, codes, k: int, d: int):
    """The matching plane words [N, nb] of bit-plane table rows ``rows``
    (int32 [E+1, >= 2k*nb], rows clamped) under ``codes`` [N]."""
    nb = d // 32
    planes = from_u32_bits(bitmaps[rows.clamp(0, bitmaps.shape[0] - 1), : 2 * k * nb])
    return match_words(planes.reshape(-1, k, 2, nb), codes, k)


def _split_terms(bitmaps, iv, code, k: int, d: int):
    """Per end of ``iv`` [B, 2] under one code per read: (block, the end's
    in-block offset, its code, the matching plane words [2B, nb]) on the
    bit-plane table int32 [E+1, >= 2k*nb] (rows clamped)."""
    ends, codes = iv.reshape(-1), code.repeat_interleave(2)
    block = ends // d
    return block, ends, codes, _plane_matches(bitmaps, block, codes, k, d)


def lf_round_split_reference(bitmaps, occ, iv, code, dollar, k: int, d: int) -> torch.Tensor:
    """Plain PyTorch split-table round on any device: int64 [B, 2] new
    intervals of ``iv`` [B, 2] under one code per read."""
    block, ends, codes, matched = _split_terms(bitmaps, iv, code, k, d)
    cnt = from_u32_bits(occ[block.clamp(max=occ.shape[0] - 1), codes.clamp(max=occ.shape[1] - 1)])
    count = popcount32(matched & boundary_masks(ends % d, d // 32)).sum(dim=-1)
    hit = (block[:, None] == dollar[2]) & (codes[:, None] == dollar[1]) & (ends[:, None] > dollar[0])
    return ((cnt + count - hit.sum(dim=-1)) & FULL).view(-1, 2)


def lf_round_ac_reference(bitmaps, occ_slim, iv, code, dollar, k: int, d: int) -> torch.Tensor:
    """Plain PyTorch alternate-counters round on any device: int64 [B, 2]
    new intervals of ``iv`` [B, 2] under one code per read."""
    S = 4**k // 2
    block, ends, codes, matched = _split_terms(bitmaps, iv, code, k, d)
    back = ((block & 1) != 0) ^ (codes >= S)
    cnt = from_u32_bits(occ_slim[(block + back).clamp(max=occ_slim.shape[0] - 1), codes & (S - 1)])
    masks = boundary_masks(ends % d, d // 32)
    masks = torch.where(back[:, None], masks ^ FULL, masks)
    count = popcount32(matched & masks).sum(dim=-1)
    at = (block[:, None] == dollar[2]) & (codes[:, None] == dollar[1])
    past = ends[:, None] > dollar[0]
    count = count - (at & torch.where(back[:, None], ~past, past)).sum(dim=-1)
    return (torch.where(back, cnt - count, cnt + count) & FULL).view(-1, 2)


def lf_answer_owned_reference(bitmaps, occ, req, shard: int, e_local: int, dollar, k: int, d: int) -> torch.Tensor:
    """Plain PyTorch owner answer (K9, see ``lf_answer_owned``) on any
    device: int32 [N] (uint32 bits) of the requests ``req`` int32 [N, 3]."""
    block, codes, ends = from_u32_bits(req).unbind(1)
    owned = block // e_local == shard
    local = torch.where(owned, block - shard * e_local, 0)
    matched = _plane_matches(bitmaps, local, codes, k, d)
    cnt = from_u32_bits(occ[local.clamp(max=occ.shape[0] - 1), codes.clamp(max=occ.shape[1] - 1)])
    count = popcount32(matched & boundary_masks(ends % d, d // 32)).sum(dim=-1)
    hit = (block[:, None] == dollar[2]) & (codes[:, None] == dollar[1]) & (ends[:, None] > dollar[0])
    out = torch.where(owned, (cnt + count - hit.sum(dim=-1)) & FULL, 0)
    return to_u32_bits(out)


def _check_words(table, name: str, width: int, what: str) -> None:
    if table.dtype != torch.int32 or table.dim() != 2:
        raise ValueError(f"{name} must be int32 [rows, words], got {table.dtype} {tuple(table.shape)}")
    if table.shape[1] < width:
        raise ValueError(f"rows of {table.shape[1]} words cannot hold {what} ({width} words)")


def _check(entries, iv, code, dollar, k: int, d: int, name: str = "entries", pairs: bool = False,
           width: int | None = None) -> None:
    """The checks every wrapper makes; ``entries`` must hold ``width`` words
    a row (default a fused row, 2k*nb + 4^k)."""
    if not 1 <= k <= 8:
        raise ValueError(f"k must be in [1, 8], got {k}")
    if d <= 0 or d % 32:
        raise ValueError(f"d must be a positive multiple of 32, got {d}")
    _check_words(entries, name, 2 * k * (d // 32) + 4**k if width is None else width, f"k={k} d={d}")
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


def _launch(fn: str, table, iv, code, dollar, k: int, d: int, *shape, library: str = "lf_round",
            tables: tuple = (), extra: tuple = ()) -> torch.Tensor:
    """Launch ``fn`` of ``library`` on CUDA tensors: its arguments are
    ``table``, ``shape``, the table's row words, then ``tables`` (pointer,
    rows, row words each), k, nb, iv, code, dollar, out, ``extra``
    pointers, n and the stream. Raises if the kernel cannot be built or
    launched."""
    from tpufm_torch import kernels

    lib = kernels.library(library)
    out = torch.empty_like(iv)
    more = [x for t in tables for x in (t.data_ptr(), t.shape[0], t.shape[1])]
    with torch.cuda.device(iv.device):
        stream = torch.cuda.current_stream(iv.device).cuda_stream
        err = getattr(lib, fn)(
            table.data_ptr(), *shape, table.shape[1], *more, k, d // 32,
            iv.data_ptr(), code.data_ptr(), dollar.data_ptr(), out.data_ptr(),
            *(t.data_ptr() for t in extra), code.shape[0], stream,
        )
    if err:
        raise RuntimeError(f"{fn} kernel launch failed: {kernels.error_string(library, err)}")
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


def lf_round_paired(entries_paired, iv, code, dollar, k: int, d: int):
    """Paired round of both ends of every read (see the module docstring):
    ``entries_paired`` int32 [E+1, 2W], W >= 2k*nb + 4^k; ``iv`` int64 [B,
    2], ``code`` int64 [B]; (int64 [B, 2], bool [B] ok). CPU tensors take
    the plain version; CUDA tensors launch the kernel, one thread per read,
    and a kernel that cannot be built or launched raises."""
    _check(entries_paired, iv, code, dollar, k, d, name="entries_paired", pairs=True,
           width=2 * (2 * k * (d // 32) + 4**k))
    if entries_paired.shape[1] % 2:
        raise ValueError(f"paired rows of {entries_paired.shape[1]} words are not two rows")
    if iv.device.type == "cpu":
        return lf_round_paired_reference(entries_paired, iv, code, dollar, k, d)
    ok = torch.empty(iv.shape[0], dtype=torch.bool, device=iv.device)
    if iv.numel() == 0:
        return torch.empty_like(iv), ok
    global PAIRED_LAUNCHES
    out = _launch("tpufm_lf_round_paired", entries_paired, iv, code, dollar, k, d,
                  entries_paired.shape[0], extra=(ok,))
    PAIRED_LAUNCHES += 1
    return out, ok


def _check_split(bitmaps, counters, name: str, rows: int, iv, code, dollar, k: int, d: int) -> None:
    _check(bitmaps, iv, code, dollar, k, d, name="bitmaps", pairs=True, width=2 * k * (d // 32))
    _check_words(counters, name, rows, f"k={k}")
    if counters.device != bitmaps.device or not counters.is_contiguous():
        raise ValueError(f"{name} must be contiguous and on the bitmaps' device")


def lf_round_split(bitmaps, occ, iv, code, dollar, k: int, d: int) -> torch.Tensor:
    """Split-table round of both ends of every read (see the module
    docstring): ``bitmaps`` int32 [E+1, >= 2k*nb], ``occ`` int32 [E+1, 4^k],
    ``iv`` int64 [B, 2], ``code`` int64 [B]; int64 [B, 2]. CPU tensors take
    the plain version; CUDA tensors launch K8, one thread per read, and a
    kernel that cannot be built or launched raises."""
    _check_split(bitmaps, occ, "occ", 4**k, iv, code, dollar, k, d)
    if iv.device.type == "cpu":
        return lf_round_split_reference(bitmaps, occ, iv, code, dollar, k, d)
    if iv.numel() == 0:
        return torch.empty_like(iv)
    global SPLIT_LAUNCHES
    out = _launch("tpufm_lf_round_split", bitmaps, iv, code, dollar, k, d, bitmaps.shape[0],
                  library="lf_round_split", tables=(occ,))
    SPLIT_LAUNCHES += 1
    return out


def lf_round_ac(bitmaps, occ_slim, iv, code, dollar, k: int, d: int) -> torch.Tensor:
    """Alternate-counters round of both ends of every read (see the module
    docstring): ``bitmaps`` int32 [E+1, >= 2k*nb], ``occ_slim`` int32 [E+2,
    4^k / 2], ``iv`` int64 [B, 2], ``code`` int64 [B]; int64 [B, 2]. CPU
    tensors take the plain version; CUDA tensors launch K8, one thread per
    read, and a kernel that cannot be built or launched raises."""
    _check_split(bitmaps, occ_slim, "occ_slim", 4**k // 2, iv, code, dollar, k, d)
    if iv.device.type == "cpu":
        return lf_round_ac_reference(bitmaps, occ_slim, iv, code, dollar, k, d)
    if iv.numel() == 0:
        return torch.empty_like(iv)
    global AC_LAUNCHES
    out = _launch("tpufm_lf_round_ac", bitmaps, iv, code, dollar, k, d, bitmaps.shape[0],
                  library="lf_round_split", tables=(occ_slim,))
    AC_LAUNCHES += 1
    return out


def lf_answer_owned(bitmaps, occ, req, shard: int, e_local: int, dollar, k: int, d: int) -> torch.Tensor:
    """K9, the sharded engine's owner answer (see the module docstring):
    shard ``shard``'s rows of the split tables, ``bitmaps`` int32 [E_local,
    >= 2k*nb] and ``occ`` int32 [E_local, 4^k], ``e_local`` rows a shard;
    the requests ``req`` int32 [N, 3] (uint32 block, code, interval); the
    replicated ``dollar`` int64 [3, k]. Returns int32 [N] (uint32 bits): each
    owned request's new interval end, 0 for every other. CPU tensors take the
    plain version; CUDA tensors launch K9, one thread per request, and a
    kernel that cannot be built or launched raises."""
    if not 1 <= k <= 8:
        raise ValueError(f"k must be in [1, 8], got {k}")
    if d <= 0 or d % 32:
        raise ValueError(f"d must be a positive multiple of 32, got {d}")
    if not 0 <= shard < 2**32 or not 0 < e_local < 2**32:
        raise ValueError(f"shard {shard} and e_local {e_local} must be uint32, e_local > 0")
    _check_words(bitmaps, "bitmaps", 2 * k * (d // 32), f"k={k} d={d}")
    _check_words(occ, "occ", 4**k, f"k={k}")
    if req.dtype != torch.int32 or req.dim() != 2 or req.shape[1] != 3:
        raise ValueError(f"req must be int32 [N, 3] (block, code, interval), got {req.dtype} {tuple(req.shape)}")
    if dollar.dtype != torch.int64 or tuple(dollar.shape) != (3, k):
        raise ValueError(f"dollar must be int64 [3, {k}], got {dollar.dtype} {tuple(dollar.shape)}")
    if not all(t.is_contiguous() for t in (bitmaps, occ, req, dollar)):
        raise ValueError("bitmaps, occ, req and dollar must be contiguous")
    devices = {t.device for t in (bitmaps, occ, req, dollar)}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devices))}")
    if req.device.type == "cpu":
        return lf_answer_owned_reference(bitmaps, occ, req, shard, e_local, dollar, k, d)
    if req.device.type != "cuda":
        raise ValueError(f"the owner answer runs on cpu or cuda tensors, got {req.device}")
    out = torch.empty(req.shape[0], dtype=torch.int32, device=req.device)
    if req.shape[0] == 0:
        return out
    from tpufm_torch import kernels

    lib = kernels.library("lf_round_split")
    with torch.cuda.device(req.device):
        stream = torch.cuda.current_stream(req.device).cuda_stream
        err = lib.tpufm_lf_answer_owned(
            bitmaps.data_ptr(), bitmaps.shape[0], bitmaps.shape[1], occ.data_ptr(), occ.shape[0],
            occ.shape[1], k, d // 32, req.data_ptr(), shard, e_local, dollar.data_ptr(), out.data_ptr(),
            req.shape[0], stream,
        )
    if err:
        raise RuntimeError(f"tpufm_lf_answer_owned kernel launch failed: "
                           f"{kernels.error_string('lf_round_split', err)}")
    global OWNED_LAUNCHES
    OWNED_LAUNCHES += 1
    return out


def lf_round_indexed(entries, iv, code, dollar, k: int, d: int) -> torch.Tensor:
    """The round as ``PallasEngine`` runs it (pallas_kernel.py:176-185):
    torch's own indexing gathers each end's row ``entries[min(iv // d, E)]``
    outside the kernel, then ``lf_round_rows`` computes on the rows."""
    rows = entries[(iv // d).clamp(max=entries.shape[0] - 1)]
    return lf_round_rows(rows, iv, code, dollar, k, d)
