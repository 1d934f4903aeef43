"""The sampled-suffix-array walk on one device: BWT rows to text positions.

Counterparts of ``build_locate_tables`` (tpufm/engine/xla.py:1352),
``make_locate_fn`` (:970), ``LocateEngine`` (:1064) and the lane compaction
of ``locate_compacted`` (:1102-1160). Contract of the walk, for every lane p
(exactly what ``make_locate_fn`` computes)::

    exactly sample_rate iterations, each on row = rows[min(p // d, E)]
    (clamped as a JAX gather clamps):
      if p is marked (mark bit of p, tested before the hop):
          rank = min(mark_rank + marked bits of the row before p % d,
                     n_samples - 1), and the lane freezes with its hop count
      else one LF(1) hop: p = K1's round at k=1 on the row's first
          2*nb + 4 words, c being the BWT character at p from the row's
          bit-planes ('$' correction included)
    result = samples[rank] + hops (mod 2^32), or 0xFFFFFFFF if never marked

A fused locate row is uint32 [2*nb LF(1) plane words | 4 LF(1) counters |
nb mark words | mark rank]; rows and text positions are int64 tensors
holding uint32 values, table words and samples int32 tensors holding the
uint32 bits, dollar int64 [3, 1] (pos, base, block of the k=1 '$').

``locate_walk`` is the wrapper (K4): a CPU tensor goes to the plain PyTorch
version ``locate_walk_reference``; a CUDA tensor launches the kernel in
tpufm_torch/csrc/locate_walk.cu (a persistent grid whose warps refill
finished lanes from a queue) or raises. The JAX walk is plain jnp (no
``pallas_call``); K4 is a new kernel because the walk is every locate
path's hot loop. ``LocateEngine`` pads its device copy of the rows to a
multiple of 4 words (24 at d=192), so that a hop loads its row in aligned
vectors; the host ``LocateTables`` keep JAX's 3*nb + 5.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpufm_torch.bitops import FULL, boundary_masks, from_u32_bits, popcount32
from tpufm_torch.device import resolve_device
from tpufm_torch.engine.lf_round import lf_round_rows_reference
from tpufm_torch.engine.search import _int64, _rows, _words, stream_waves
from tpufm_torch.engine.tables import _check_d, _dollar, concat_words
from tpufm_torch.host.locate import LocateIndex, locate_hits_compacted
from tpufm_torch.profiling import span

#: kernel launches made by ``locate_walk`` in this process (plain-path calls
#: on CPU tensors do not count)
LAUNCHES = 0


@dataclasses.dataclass
class LocateTables:
    """Host state of one locate engine.

    rows:    uint32 [E+1, 3*nb + 5] fused locate rows (module docstring).
    samples: uint32 [n_samples] SA values of the sampled rows, in row order.
    dollar:  uint32 [3, 1] pos, base and block of the k=1 '$'.
    rows and samples are int32 tensors of the same bits on the device for
    tables built there (``build_locate_device(return_host=False)``).
    """

    d: int
    sample_rate: int
    rows: np.ndarray
    samples: np.ndarray
    dollar: np.ndarray

    @property
    def bwtsize(self) -> int:
        """The sentinel row's last LF(1) counter: every text position."""
        return int(self.rows[-1, 2 * (self.d // 32) + 3])


def locate_tables_from_index(loc: LocateIndex) -> LocateTables:
    """The fused locate rows of ``loc`` (build_locate_tables, xla.py:1352),
    concatenated where the tables lie (host or device)."""
    lf1 = loc.lf1
    if lf1.config.k != 1:
        raise ValueError(
            f"LocateIndex.lf1 must be a k=1 index (got k={lf1.config.k}); "
            "the locate walk takes single-character LF steps"
        )
    rows = concat_words([lf1.bitmaps, lf1.occ, loc.mark_words, loc.mark_rank[:, None]])
    samples = loc.samples if isinstance(loc.samples, torch.Tensor) else np.asarray(loc.samples, dtype=np.uint32)
    return LocateTables(d=lf1.config.d, sample_rate=loc.sample_rate, rows=rows,
                        samples=samples, dollar=_dollar(lf1))


def locate_tables_from_jax(tables: dict, d: int, sample_rate: int) -> LocateTables:
    """Port the JAX locate state (``LocateEngine(...).tables`` or
    ``SearchLocateEngine(...).loc_tables``) to the port's, so that both
    engines walk identical tables. The rows must be 3*nb + 5 words, and
    their count ceil(bwtsize / d) + 1, bwtsize being the sentinel row's last
    LF(1) counter."""
    arr = {name: np.asarray(v) for name, v in tables.items()}
    _check_d(d)
    if sample_rate < 1:
        raise ValueError(f"sample_rate must be >= 1, got {sample_rate}")
    rows = arr["locate_rows"].astype(np.uint32, copy=False)
    if rows.ndim != 2 or rows.shape[1] != 3 * (d // 32) + 5:
        raise ValueError(f"locate rows {rows.shape} are not [E+1, {3 * (d // 32) + 5}] for d={d}")
    out = LocateTables(
        d=d, sample_rate=sample_rate, rows=rows,
        samples=arr["samples"].astype(np.uint32, copy=False),
        dollar=np.stack([arr["dollar_pos"], arr["dollar_base"], arr["dollar_block"]]).astype(np.uint32),
    )
    if (out.dollar.shape != (3, 1) or rows.shape[0] != -(-out.bwtsize // d) + 1
            or out.dollar[2, 0] != out.dollar[0, 0] // d):
        raise ValueError(f"locate tables do not fit d={d} (row count or dollar_block)")
    return out


def locate_walk_reference(rows_tbl, samples, dollar, p, d: int, sample_rate: int) -> torch.Tensor:
    """Plain PyTorch walk on any device, every lane for all sample_rate
    iterations as ``make_locate_fn`` runs it: int64 [N] SA values."""
    nb = d // 32
    bmw = 2 * nb
    last = samples.shape[0] - 1
    rank = torch.zeros_like(p)
    hops = torch.zeros_like(p)
    done = torch.zeros(p.shape, dtype=torch.bool, device=p.device)
    for hop in range(sample_rate):
        off = p % d
        row = rows_tbl[(p // d).clamp(max=rows_tbl.shape[0] - 1)]
        word = (off // 32)[:, None]
        sh = 31 - off % 32
        marks = from_u32_bits(row[:, bmw + 4:bmw + 4 + nb])
        marked = ((marks.gather(1, word)[:, 0] >> sh) & 1) != 0
        pre = popcount32(marks & boundary_masks(off, nb)).sum(dim=-1)
        newly = marked & ~done
        rank = torch.where(newly, ((from_u32_bits(row[:, bmw + 4 + nb]) + pre) & FULL).clamp(max=last), rank)
        hops = torch.where(newly, hop, hops)
        done |= marked
        planes = from_u32_bits(row[:, :bmw])
        c = ((planes.gather(1, word)[:, 0] >> sh) & 1) | (((planes.gather(1, word + nb)[:, 0] >> sh) & 1) << 1)
        p = torch.where(done, p, lf_round_rows_reference(row, p, c, dollar, 1, d))
    return torch.where(done, (from_u32_bits(samples[rank]) + hops) & FULL, FULL)


def _check(rows_tbl, samples, dollar, p, d: int, sample_rate: int) -> None:
    _check_d(d)
    if sample_rate < 1:
        raise ValueError(f"sample_rate must be >= 1, got {sample_rate}")
    width = 3 * (d // 32) + 5
    if rows_tbl.dtype != torch.int32 or rows_tbl.dim() != 2 or rows_tbl.shape[0] < 1 or rows_tbl.shape[1] < width:
        raise ValueError(f"rows must be int32 [rows >= 1, words >= {width}], got {rows_tbl.dtype} {tuple(rows_tbl.shape)}")
    if samples.dtype != torch.int32 or samples.dim() != 1 or samples.numel() < 1:
        raise ValueError(f"samples must be int32 [n >= 1], got {samples.dtype} {tuple(samples.shape)}")
    if dollar.dtype != torch.int64 or tuple(dollar.shape) != (3, 1):
        raise ValueError(f"dollar must be int64 [3, 1], got {dollar.dtype} {tuple(dollar.shape)}")
    if p.dtype != torch.int64 or p.dim() != 1:
        raise ValueError(f"p must be int64 [N], got {p.dtype} {tuple(p.shape)}")
    tensors = (rows_tbl, samples, dollar, p)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("rows, samples, dollar and p must be contiguous")
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devices))}")
    if p.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the locate walk runs on cpu or cuda tensors, got {p.device}")


def locate_walk(rows_tbl, samples, dollar, p, d: int, sample_rate: int) -> torch.Tensor:
    """SA value of every BWT row in ``p`` (see the module contract).

    CPU tensors take the plain version; CUDA tensors launch the kernel, and
    a kernel that cannot be built or launched raises."""
    _check(rows_tbl, samples, dollar, p, d, sample_rate)
    if p.device.type == "cpu":
        return locate_walk_reference(rows_tbl, samples, dollar, p, d, sample_rate)
    out = torch.empty_like(p)
    if p.numel() == 0:
        return out
    global LAUNCHES
    from tpufm_torch import kernels

    lib = kernels.library("locate_walk")
    next_lane = torch.zeros(1, dtype=torch.int64, device=p.device)  # the lane queue's head
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = lib.tpufm_locate_walk(
            rows_tbl.data_ptr(), rows_tbl.shape[0], rows_tbl.shape[1], d // 32,
            samples.data_ptr(), samples.shape[0], dollar.data_ptr(), p.data_ptr(),
            out.data_ptr(), p.shape[0], sample_rate, next_lane.data_ptr(), stream,
        )
    if err:
        raise RuntimeError(f"locate_walk kernel launch failed: {kernels.error_string('locate_walk', err)}")
    LAUNCHES += 1
    return out


def locate_compacted(walk_rows, rows: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Positions of ``rows`` (any shape) through ``walk_rows`` (int64 [N] ->
    int64 [N]), 0 where not ``valid``: only the valid lanes walk. A boolean
    index packs them (one device-to-host read of their count) and a masked
    store puts them back, the work of ``compact_slots`` and
    ``scatter_back`` (xla.py:1102-1118); the packing is the span
    ``tpufm.locate.compact``; JAX compacts into a fixed budget
    behind a ``lax.cond`` only because its shapes must be static. Every
    lane walks independently, so the positions are the same either way."""
    pos = torch.zeros_like(rows)
    with span("tpufm.locate.compact"):
        lanes = rows[valid]
    pos[valid] = walk_rows(lanes)
    return pos


class LocateEngine(torch.nn.Module):
    """Device-resident locate tables plus the walk over them.

    loc: a ``LocateIndex`` or ready ``LocateTables`` (e.g. from
    ``locate_tables_from_jax``). ``walk`` of the methods: None runs K4
    (``locate_walk``); a function of the same signature, such as the plain
    ``locate_walk_reference``, replaces it.
    """

    #: rows per wave of ``locate_rows`` (the JAX engine's; not tuned here)
    WAVE = 1 << 21

    def __init__(self, loc: LocateIndex | LocateTables, device: str | torch.device):
        super().__init__()
        tables = loc if isinstance(loc, LocateTables) else locate_tables_from_index(loc)
        device = resolve_device(device)
        self.d, self.sample_rate, self.bwtsize = tables.d, tables.sample_rate, tables.bwtsize
        self.register_buffer("rows", _rows(tables.rows, device))
        self.register_buffer("samples", _words(tables.samples, device))
        self.register_buffer("dollar", _int64(tables.dollar, device))

    @property
    def device(self) -> torch.device:
        return self.rows.device

    def walk(self, p: torch.Tensor, walk=None) -> torch.Tensor:
        """int64 [N] BWT rows on this engine's device -> int64 [N] SA values."""
        return (walk or locate_walk)(self.rows, self.samples, self.dollar, p, self.d, self.sample_rate)

    def locate_rows(self, rows, wave: int | None = None, walk=None) -> np.ndarray:
        """uint32 [N] host BWT rows -> uint32 [N] SA values, in waves of
        ``wave`` rows."""
        rows = np.asarray(rows, dtype=np.uint32).astype(np.int64)
        return stream_waves(rows, wave or self.WAVE, lambda r: self.walk(r, walk), self.device)

    def locate_hits(self, intervals, max_hits: int, walk=None) -> np.ndarray:
        """uint32 [B, 2] search intervals -> uint32 [B, max_hits] text
        positions of each interval's first max_hits rows, 0xFFFFFFFF past
        its count; only the rows inside an interval walk."""
        return locate_hits_compacted(lambda r: self.locate_rows(r, walk=walk), intervals, max_hits)
