"""Row gather: ``out[j] = table[clamp(idx[j], 0, E - 1)]``.

Counterpart of the Pallas kernel ``_gather_kernel`` / ``make_dma_gather``
(tpufm/engine/dma_gather.py:40-124), the gather of ``XLAEngine(gather="dma")``.
Tables are int32 [E, W] tensors holding uint32 bits, indices int64 [N]; the
result is int32 [N, W]. Any N and any W >= 1: the TPU's rule that W be a
multiple of 128 words is a DMA constraint and is not carried over, nor are
its ``outstanding`` and ``CHUNK`` knobs. Indices are clamped into the table
as a JAX gather clamps them.

``row_gather`` is the wrapper the engine calls: a CPU tensor goes to the
plain PyTorch version ``row_gather_reference``; a CUDA tensor launches the
kernel in tpufm_torch/csrc/row_gather.cu or raises. The kernel copies tiles
of consecutive rows, whose output is one contiguous run of words, over a
persistent grid, a block a tile at a time: its indices loaded once into
shared memory, its output written in whole lines, evict-first, while the
table's rows are read with an evict-last policy so that they stay in L2.
``plan`` picks the copy path and the tile and grid sizes (pure arithmetic,
tested on the CPU): 16-byte units where W % 4 == 0 and both bases are
16-byte aligned, else words.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

#: kernel launches made by ``row_gather`` in this process (plain-path calls
#: on CPU tensors do not count)
LAUNCHES = 0

#: the kernel's path codes (``Path`` in row_gather.cu)
PATHS = {"int4": 0, "word": 1}
#: threads of a block, the 16-byte elements each keeps in flight, and the
#: blocks an SM holds (kThreads, kUnroll, kBlocksPerSM in row_gather.cu)
THREADS, UNROLL, BLOCKS_PER_SM = 256, 4, 6
#: at most this many rows a tile (their indices sit in shared memory)
MAX_TILE_ROWS = 1024


class Plan(NamedTuple):
    path: str  # a key of PATHS
    tile_rows: int
    blocks: int


def copy_path(W: int, table_ptr: int, out_ptr: int) -> str:
    """The kernel's copy path for rows of W words at these base addresses:
    16-byte units ("int4") where W % 4 == 0 and both bases are 16-byte
    aligned, else words ("word")."""
    return "int4" if W % 4 == 0 and table_ptr % 16 == 0 and out_ptr % 16 == 0 else "word"


def tile_rows(W: int) -> int:
    """Rows of a tile: as many as fill one pass of the block (THREADS *
    UNROLL 16-byte elements, 4 words each), at least 1 and at most
    MAX_TILE_ROWS."""
    return min(MAX_TILE_ROWS, max(1, THREADS * UNROLL * 4 // W))


def grid_blocks(n: int, rows: int, sms: int) -> int:
    """The persistent grid: as many blocks as the SMs hold at once, and no
    more than there are tiles."""
    return max(1, min(-(-n // rows), sms * BLOCKS_PER_SM))


def plan(n: int, W: int, table_ptr: int, out_ptr: int, sms: int) -> Plan:
    rows = tile_rows(W)
    return Plan(copy_path(W, table_ptr, out_ptr), rows, grid_blocks(n, rows, sms))


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def row_gather_reference(table, idx, out=None) -> torch.Tensor:
    """Plain PyTorch row gather on any device, into ``out`` when given."""
    rows = idx.clamp(0, table.shape[0] - 1)
    if out is None:
        return table[rows]
    return torch.index_select(table, 0, rows, out=out)


def _check(table, idx, out) -> None:
    if table.dtype != torch.int32 or table.dim() != 2 or table.shape[0] < 1 or table.shape[1] < 1:
        raise ValueError(f"table must be int32 [rows >= 1, words >= 1], got {table.dtype} {tuple(table.shape)}")
    if idx.dtype != torch.int64 or idx.dim() != 1:
        raise ValueError(f"idx must be int64 [N], got {idx.dtype} {tuple(idx.shape)}")
    tensors = [table, idx]
    if out is not None:
        want = (idx.shape[0], table.shape[1])
        if out.dtype != torch.int32 or tuple(out.shape) != want:
            raise ValueError(f"out must be int32 {list(want)}, got {out.dtype} {tuple(out.shape)}")
        tensors.append(out)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("table, idx and out must be contiguous")
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devices))}")
    if idx.device.type not in ("cpu", "cuda"):
        raise ValueError(f"row_gather runs on cpu or cuda tensors, got {idx.device}")


def row_gather(table, idx, out=None) -> torch.Tensor:
    """``table[clamp(idx, 0, E - 1)]``, written into ``out`` (int32 [N, W])
    when given so that a caller can reuse one buffer across calls.

    CPU tensors take the plain version; CUDA tensors launch the kernel, and
    a kernel that cannot be built or launched raises."""
    _check(table, idx, out)
    if idx.device.type == "cpu":
        return row_gather_reference(table, idx, out)
    if out is None:
        out = torch.empty((idx.shape[0], table.shape[1]), dtype=torch.int32, device=idx.device)
    if idx.numel() == 0:
        return out
    global LAUNCHES
    from tpufm_torch import kernels

    lib = kernels.library("row_gather")
    p = plan(idx.shape[0], table.shape[1], table.data_ptr(), out.data_ptr(), _sms(idx.device))
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream(idx.device).cuda_stream
        err = lib.tpufm_row_gather(
            table.data_ptr(), table.shape[0], table.shape[1], idx.data_ptr(), out.data_ptr(),
            idx.shape[0], PATHS[p.path], p.tile_rows, p.blocks, stream,
        )
    if err:
        raise RuntimeError(f"row_gather kernel launch failed: {kernels.error_string('row_gather', err)}")
    LAUNCHES += 1
    return out
