"""The k-step FM-index and the locate tables built on the device.

Counterpart of tpufm/index/builder_device.py (``_build_tables`` :35,
``build_index_device`` :106, ``_locate_tables`` :218,
``build_locate_device`` :257). The pipeline:

  suffix array  prefix doubling on the device (index.sa_device)
  text pack     the text 2 bits a base (csrc/build_tables.cu, wrapper
                ``pack_text_2bit``), by each ``build_tables`` call; plain
                version ``pack_text_2bit_reference``
  tables        K7 (csrc/build_tables.cu, wrapper ``build_tables``): the k
                BWT levels straight from the suffix array and the packed
                text, packed into the bit-planes, the per-block k-mer
                counts, and the '$' positions; plain version
                ``build_tables_reference``, tpufm's jnp pass in torch;
                also on a slice of the suffix array (``p0``), a shard of
                the sharded build (index.builder_sharded)
  corrections   the k + 1 point corrections ('$' counted as its 'A' k-mer,
                the tail padding as k-mer 0), the exclusive cumulative sum
                plus the sentinel row, and C (4^k scalars on the host)
  locate        mark bits SA % s == 0, the samples in row order, the packed
                mark words and the per-block mark rank (plain torch)

Every array is bit-identical to the host builders' (``host.index.
build_index``, ``host.locate.build_locate``) and to tpufm's device builders.
``return_host=True`` gives numpy with the host builders' dtypes;
``return_host=False`` leaves the large tables on the device as int32
tensors holding the uint32 bits (``occ``, ``bitmaps``; the locate
``samples``, ``mark_words``, ``mark_rank``), which ``SearchEngine`` and
``LocateEngine`` take as they lie. ``dollar_pos`` and ``dollar_base`` are
always numpy. Counters are summed in int64 and kept mod 2^32, which is
tpufm's uint32 arithmetic.
"""

from __future__ import annotations

import numpy as np
import torch

from tpufm_torch.bitops import FULL, popcount32, to_u32_bits
from tpufm_torch.engine.seed import pack_query_words
from tpufm_torch.engine.tables import host_words
from tpufm_torch.host.index import IndexConfig, KStepFMIndex, c_array, normalize_reference
from tpufm_torch.host.locate import LocateIndex
from tpufm_torch.index.sa_device import check_size, suffix_array_device_arr, upload_text

#: kernel launches made by ``build_tables`` and by ``pack_text_2bit`` in this
#: process (plain-path calls on CPU tensors do not count)
LAUNCHES = 0
PACK_LAUNCHES = 0

#: a word's 32 bit positions, MSB-first (position j at bit 31 - j)
_SHIFTS = 31 - np.arange(32)


def _pack_words(bits: torch.Tensor) -> torch.Tensor:
    """[..., 32] 0/1 int64 -> [...] int64 words, position j at bit 31 - j."""
    return (bits << torch.from_numpy(_SHIFTS).to(bits.device)).sum(dim=-1)


def build_tables_reference(codes: torch.Tensor, sa: torch.Tensor, k: int, d: int, p0: int = 0,
                           big: int | None = None):
    """Plain PyTorch K7 on any device (tpufm's ``_build_tables`` in torch,
    and per shard its ``_table_program``): uint8 text [n] and rows [p0, p0 +
    rows) of its suffix array, int32 [rows] (p0 a multiple of d; the whole
    array by default) -> (counts int32 [E, 4^k], E = ceil(rows / d),
    uncorrected; bitmaps int32 [E+1, k, 2, d/32] holding the uint32 words,
    row E zero; dollar_pos int64 [k], the global rows of the suffixes below
    k that the slice holds, 0 elsewhere). ``big`` is the suffix array's
    length, n + 1: a row p0 + p at or past it is a pad, read as 'A' at every
    level (k-mer 0), as past the last block."""
    n, rows = codes.shape[0], sa.shape[0]
    big, nb, dev = n + 1, d // 32, codes.device
    E = -(-rows // d)
    t = torch.cat([codes, torch.zeros(1, dtype=torch.uint8, device=dev)])  # '$' read as 'A'
    real = torch.arange(p0, p0 + rows, device=dev) < big
    sa = torch.where(real, sa.to(torch.int64), 0)
    (small,) = torch.nonzero(real & (sa < k), as_tuple=True)
    dollar_pos = torch.zeros(k, dtype=torch.int64, device=dev)
    dollar_pos[sa[small]] = small + p0
    pad = E * d - rows
    bitmaps = torch.zeros((E + 1, k, 2, nb), dtype=torch.int64, device=dev)
    for i in range(k):
        level = torch.where(real, t[(sa + (big - 1 - i)) % big], 0).to(torch.int64)
        level = torch.cat([level, level.new_zeros(pad)]).view(E, nb, 32)
        for plane in range(2):
            bitmaps[:E, i, plane] = _pack_words((level >> plane) & 1)
    planes = bitmaps[:E]
    counts = torch.empty((E, 4**k), dtype=torch.int32, device=dev)
    for c in range(4**k):
        m = torch.full((E, nb), FULL, dtype=torch.int64, device=dev)
        for i in range(k):
            for plane in range(2):
                words = planes[:, i, plane]
                m &= words if (c >> (2 * i + plane)) & 1 else words ^ FULL
        counts[:, c] = popcount32(m).sum(dim=1).to(torch.int32)
    return counts, to_u32_bits(bitmaps), dollar_pos


def pack_text_2bit_reference(codes: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch pack of a uint8 text [n] (2-bit codes; higher bits
    ignored, as the planes ignore them) on any device -> int32 [ceil(n / 16)
    + 1] holding ``engine.seed.pack_text_words``' uint32 words: 16 bases a
    word, MSB-first, zero past n, and one zero guard word."""
    words = torch.zeros(-(-codes.shape[0] // 16) + 1, dtype=torch.int64, device=codes.device)
    words[:-1] = pack_query_words(codes & 3)
    return to_u32_bits(words)


def pack_text_2bit(codes: torch.Tensor) -> torch.Tensor:
    """K7's text: ``pack_text_2bit_reference``'s words, packed by
    ``build_tables`` on each call. CPU tensors take the plain version; CUDA
    tensors launch the pack kernel (csrc/build_tables.cu), which raises if
    it cannot."""
    if codes.dtype != torch.uint8 or codes.dim() != 1 or not codes.is_contiguous():
        raise ValueError(f"codes must be contiguous uint8 [n], got {codes.dtype} {tuple(codes.shape)}")
    if codes.device.type == "cpu":
        return pack_text_2bit_reference(codes)
    if codes.device.type != "cuda":
        raise ValueError(f"the pack runs on cpu or cuda tensors, got {codes.device}")
    n = codes.shape[0]
    words = torch.empty(-(-n // 16) + 1, dtype=torch.int32, device=codes.device)
    global PACK_LAUNCHES
    from tpufm_torch import kernels

    lib = kernels.library("build_tables")
    with torch.cuda.device(codes.device):
        err = lib.tpufm_pack_text(codes.data_ptr(), n, words.data_ptr(),
                                  torch.cuda.current_stream(codes.device).cuda_stream)
    if err:
        raise RuntimeError(f"pack_text kernel launch failed: {kernels.error_string('build_tables', err)}")
    PACK_LAUNCHES += 1
    return words


def _check_tables(codes: torch.Tensor, sa: torch.Tensor, k: int, d: int, p0: int, big: int | None) -> None:
    if not 1 <= k <= 8:
        raise ValueError(f"k must be in [1, 8], got {k}")
    if d <= 0 or d % 32:
        raise ValueError(f"d must be a positive multiple of 32, got {d}")
    if codes.dtype != torch.uint8 or codes.dim() != 1:
        raise ValueError(f"codes must be uint8 [n], got {codes.dtype} {tuple(codes.shape)}")
    n1 = codes.shape[0] + 1
    if big is not None and big != n1:
        raise ValueError(f"big is the suffix array's length, n + 1 = {n1}; got {big}")
    if p0 < 0 or p0 % d:
        raise ValueError(f"p0 must be a non-negative multiple of d={d}, got {p0}")
    if sa.dtype != torch.int32 or sa.dim() != 1 or sa.shape[0] < 1 or (
            sa.shape[0] % d and p0 + sa.shape[0] < n1):
        raise ValueError(f"sa must be int32 [{n1}], or rows of it from p0 in whole blocks of d={d} (the "
                         f"last may end past row {n1}), got {sa.dtype} {tuple(sa.shape)} at p0={p0}")
    if not (codes.is_contiguous() and sa.is_contiguous()):
        raise ValueError("codes and sa must be contiguous")
    if codes.device != sa.device:
        raise ValueError(f"codes on {codes.device}, sa on {sa.device}")
    if codes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the table build runs on cpu or cuda tensors, got {codes.device}")


def build_tables(codes: torch.Tensor, sa: torch.Tensor, k: int, d: int, p0: int = 0, big: int | None = None):
    """The tables of ``build_tables_reference`` (its contract and dtypes),
    of the whole suffix array or of the slice of it that starts at row
    ``p0`` (a shard of the sharded build).

    CPU tensors take the plain version; CUDA tensors launch the pack
    (``pack_text_2bit``) and K7 on its words, and a kernel that cannot be
    built or launched raises."""
    _check_tables(codes, sa, k, d, p0, big)
    if codes.device.type == "cpu":
        return build_tables_reference(codes, sa, k, d, p0)
    words = pack_text_2bit(codes)
    n, nb, dev, rows = codes.shape[0], d // 32, codes.device, sa.shape[0]
    E = -(-rows // d)
    bitmaps = torch.empty((E + 1, k, 2, nb), dtype=torch.int32, device=dev)
    bitmaps[E].zero_()
    counts = torch.empty((E, 4**k), dtype=torch.int32, device=dev)
    # K7 writes a '$' row within the slice: -1 marks the entries of '$'
    # rows outside it, which leave as 0, as the whole array's unset ones
    dollar_pos = torch.full((k,), -1 if p0 else 0, dtype=torch.int64, device=dev)
    global LAUNCHES
    from tpufm_torch import kernels

    lib = kernels.library("build_tables")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tpufm_build_tables(
            words.data_ptr(), n, sa.data_ptr(), rows, p0, k, nb, bitmaps.data_ptr(), counts.data_ptr(),
            dollar_pos.data_ptr(), stream,
        )
    if err:
        raise RuntimeError(f"build_tables kernel launch failed: {kernels.error_string('build_tables', err)}")
    LAUNCHES += 1
    if p0:
        dollar_pos = torch.where(dollar_pos >= 0, dollar_pos + p0, 0)
    return counts, bitmaps, dollar_pos


def build_index_device(
    reference,
    config: IndexConfig = IndexConfig(),
    return_host: bool = True,
    device: str | torch.device = "cuda",
    sa_dev: torch.Tensor | None = None,
    codes_dev: torch.Tensor | None = None,
) -> KStepFMIndex:
    """The k-step FM-index of ``reference`` (see ``normalize_reference``)
    built on ``device``, bit-identical to ``host.index.build_index``.

    ``sa_dev`` / ``codes_dev``: the suffix array (int32 [n+1]) and the text
    (uint8 [n]) already on the device, so that an index, its k=1 tail and
    the locate tables share one suffix sort and one upload.
    ``return_host=False`` leaves ``occ`` and ``bitmaps`` on the device
    (int32 tensors holding the uint32 words)."""
    codes = normalize_reference(reference)
    k, d = config.k, config.d
    n = int(codes.shape[0])
    check_size(n)
    big, C = n + 1, config.num_counters
    E = config.num_entries(big)
    if codes_dev is None:
        codes_dev = upload_text(codes, device)
    dev = codes_dev.device
    order = suffix_array_device_arr(codes_dev) if sa_dev is None else sa_dev
    if order.shape[0] != big:
        raise ValueError(f"sa_dev has {order.shape[0]} entries, expected {big}")
    counts, bitmaps, dollar_pos_d = build_tables(codes_dev, order, k, d)

    dollar_pos = dollar_pos_d.cpu().numpy().astype(np.uint32)
    # dollar_base[m]: the k-mer at dollar_pos[m] ('$' read as 'A'), read out
    # of the rows of the packed planes that hold each '$'
    blocks = torch.from_numpy((dollar_pos // np.uint32(d)).astype(np.int64)).to(dev)
    held = host_words(bitmaps[blocks])  # [k, k, 2, nb]
    dollar_base = np.zeros(k, np.uint32)
    for m in range(k):
        off = int(dollar_pos[m]) % d
        w, b = off // 32, 31 - off % 32
        for i in range(k):
            bits = ((int(held[m, i, 0, w]) >> b) & 1) | (((int(held[m, i, 1, w]) >> b) & 1) << 1)
            dollar_base[m] |= np.uint32(bits << (2 * i))

    # the point corrections: each '$' was counted as its 'A'-read k-mer, the
    # tail padding (E*d - big positions) as k-mer 0
    counts = counts.to(torch.int64)
    for m in range(k):
        counts[int(dollar_pos[m]) // d, int(dollar_base[m])] -= 1
    counts[E - 1, 0] -= E * d - big

    # occ: the exclusive per-block prefix plus the sentinel row, then C
    occ = torch.zeros((E + 1, C), dtype=torch.int64, device=dev)
    torch.cumsum(counts, dim=0, out=occ[1:])
    del counts
    occ += torch.from_numpy(c_array(occ[-1].cpu().numpy(), dollar_base, k)).to(dev)
    occ = to_u32_bits(occ & FULL)

    if return_host:
        occ, bitmaps = host_words(occ), host_words(bitmaps)
    return KStepFMIndex(
        config=config,
        bwtsize=big,
        occ=occ,
        bitmaps=bitmaps,
        dollar_pos=dollar_pos,
        dollar_base=dollar_base,
    )


def _locate_tables(order: torch.Tensor, d: int, sample_rate: int):
    """Mark and sample tables from the suffix array (int32 [big], on any
    device; tpufm's ``_locate_tables`` in torch): (samples int32 [ceil(big /
    s)], the SA values of the marked rows in row order; mark_words int32
    [E+1, d/32], MSB-first with a zero sentinel row; mark_rank int32 [E+1],
    the marked rows before each block). One ``nonzero`` (a host sync)."""
    big, nb = order.shape[0], d // 32
    E = -(-big // d)
    marked = (order % sample_rate) == 0
    (rows,) = torch.nonzero(marked, as_tuple=True)
    samples = order[rows]
    del rows
    bits = torch.zeros(E * d, dtype=torch.int64, device=order.device)
    bits[:big] = marked
    del marked
    words = _pack_words(bits.view(E, nb, 32))
    del bits
    mark_words = torch.zeros((E + 1, nb), dtype=torch.int64, device=order.device)
    mark_words[:E] = words
    mark_rank = torch.zeros(E + 1, dtype=torch.int64, device=order.device)
    torch.cumsum(popcount32(words).sum(dim=1), dim=0, out=mark_rank[1:])
    return samples, to_u32_bits(mark_words), to_u32_bits(mark_rank & FULL)


def build_locate_device(
    reference,
    sample_rate: int = 32,
    d: int = 128,
    return_host: bool = True,
    device: str | torch.device = "cuda",
    sa_dev: torch.Tensor | None = None,
    codes_dev: torch.Tensor | None = None,
) -> LocateIndex:
    """The locate tables of ``reference`` (the k=1 LF index, mark words,
    mark rank and samples) built on ``device``, bit-identical to
    ``host.locate.build_locate``; one suffix sort (``sa_dev``, else sorted
    here) and one upload (``codes_dev``) shared with the k=1 index build.
    ``return_host=False`` leaves the tables on the device (int32 tensors
    holding the uint32 values)."""
    codes = normalize_reference(reference)
    if codes_dev is None:
        codes_dev = upload_text(codes, device)
    order = suffix_array_device_arr(codes_dev) if sa_dev is None else sa_dev
    lf1 = build_index_device(codes, IndexConfig(k=1, d=d), return_host=return_host,
                             sa_dev=order, codes_dev=codes_dev)
    samples, mark_words, mark_rank = _locate_tables(order, d, sample_rate)
    if return_host:
        samples, mark_words, mark_rank = host_words(samples), host_words(mark_words), host_words(mark_rank)
    return LocateIndex(lf1=lf1, sample_rate=sample_rate, mark_words=mark_words,
                       mark_rank=mark_rank, samples=samples)
