"""Pigeonhole seed-and-extend on one device: approximate matching at Hamming
distance m >= 1.

Counterpart of tpufm/engine/seed.py: ``pack_text_words`` (:54),
``pack_query_words`` (:71), ``_window_mask`` (:84), ``hamming_to_text``
(:94), ``seed_positions`` (:124; here ``seed_intervals`` and
``seed_positions``), ``compact_hits`` (:186),
``make_seed_extend_fn`` (:211), ``seed_extend_oracle`` (:306) and
``SeedExtendEngine`` (:322). Three passes per wave:

  1. SEED: any occurrence with <= m substitutions contains one of m+1
     disjoint read chunks exactly. Each read gives m+1 seeds of length
     Ls = floor(L/(m+1)) rounded down to a multiple of k, searched as
     ordinary reads (K1), from the prefix LUT where Ls >= lut_m and
     without it otherwise, on the same device tables.
  2. LOCATE: each seed interval expands to its first ``seed_hits`` BWT
     rows; only the rows inside it walk the sampled SA (K4). A candidate
     start is the seed's position minus its offset; candidates are sorted
     per read and neighbour-deduplicated (0xFFFFFFFF collects at the end).
  3. VERIFY: every unique candidate's L-base window of the 2-bit packed
     text against the read, XOR and popcount (K5, ``hamming_to_text``).

A read is flagged ``overflow`` when a seed interval is wider than
``seed_hits``: its hit list is then a lower bound. tpufm compacts the walk
and verify lanes into fixed budgets behind a ``lax.cond`` only because its
shapes are static; here the walk takes only the valid rows and K5 skips
invalid lanes itself, so there are no budgets, with the same results.

Words are uint32 values carried in int64 tensors (``bitops``); the packed
text lives on the device as int32 holding the uint32 bits. The text length
n must satisfy n + L < 2^32, as tpufm's.

``hamming_to_text`` is the wrapper of K5 (tpufm_torch/csrc/hamming_verify.cu):
a CPU tensor takes the plain version ``hamming_to_text_reference``; a CUDA
tensor launches the kernel or raises. JAX's verify is plain jnp (no
``pallas_call``), so K5 is a new kernel of the port.
"""

from __future__ import annotations

import numpy as np
import torch

from tpufm_torch.bitops import FULL, from_u32_bits, popcount32
from tpufm_torch.device import resolve_device
from tpufm_torch.engine.locate import LocateEngine, LocateTables, locate_compacted
from tpufm_torch.engine.search import SearchEngine, _words, stream_waves
from tpufm_torch.engine.search_locate import SearchLocateEngine
from tpufm_torch.engine.tables import Tables
from tpufm_torch.host.index import KStepFMIndex
from tpufm_torch.host.locate import LocateIndex

#: padding of position rows and of candidates that are not kept
SENTINEL = 0xFFFFFFFF
#: the low bit of every 2-bit base field of a word
_MISMASK = 0x55555555

#: kernel launches made by ``hamming_to_text`` in this process (plain-path
#: calls on CPU tensors do not count)
LAUNCHES = 0


def pack_text_words(codes: np.ndarray) -> np.ndarray:
    """2-bit codes uint8 [n] -> uint32 [ceil(n/16) + 1], 16 bases a word,
    base j at bits 31 - 2*(j%16) .. 30 - 2*(j%16) (MSB first), and one zero
    guard word at the end, so that the W+1 words of any valid window start
    lie inside the array."""
    codes = np.asarray(codes, dtype=np.uint8)
    nw = -(-codes.shape[0] // 16) + 1
    padded = np.zeros(nw * 16, dtype=np.uint8)
    padded[:codes.shape[0]] = codes
    sh = (2 * (15 - np.arange(16))).astype(np.uint32)
    return np.bitwise_or.reduce(padded.reshape(nw, 16).astype(np.uint32) << sh, axis=1)


def pack_query_words(queries: torch.Tensor) -> torch.Tensor:
    """uint8 [..., L] -> int64 [..., ceil(L/16)] words in ``pack_text_words``'
    layout (a partial last word zero-padded low)."""
    L = queries.shape[-1]
    W = -(-L // 16)
    q = torch.nn.functional.pad(queries, (0, W * 16 - L)).to(torch.int64)
    sh = 2 * (15 - torch.arange(16, dtype=torch.int64, device=queries.device))
    return (q.reshape(*queries.shape[:-1], W, 16) << sh).sum(dim=-1)


def _window_mask(L: int) -> np.ndarray:
    """Per-word keep-mask of an L-base window: whole words, then the top
    2*(L%16) bits of the last."""
    mask = np.full(-(-L // 16), 0xFFFFFFFF, dtype=np.uint32)
    if L % 16:
        mask[-1] = np.uint32(0xFFFFFFFF) << np.uint32(32 - 2 * (L % 16))
    return mask


def hamming_to_text_reference(text_words, pos, qwords, valid, L: int) -> torch.Tensor:
    """Plain PyTorch K5 on any device: int32 [B, C] Hamming distance between
    the L-base text window at ``pos`` [B, C] and read b's words ``qwords``
    [B, W]; L+1 where ``valid`` is False. Word indices past the array clamp
    to its last word, as a JAX gather clamps."""
    W = qwords.shape[-1]
    p = torch.where(valid, pos, 0)
    sh = (2 * (p % 16))[..., None]
    idx = (p // 16)[..., None] + torch.arange(W + 1, device=p.device)
    tw = from_u32_bits(text_words[idx.clamp(max=text_words.shape[0] - 1)])
    lo, hi = tw[..., :W], tw[..., 1:]
    aligned = torch.where(sh == 0, lo, ((lo << sh) & FULL) | (hi >> ((32 - sh) & 31)))
    x = aligned ^ qwords[:, None, :]
    mism = (x | (x >> 1)) & _MISMASK
    mism &= torch.from_numpy(_window_mask(L).astype(np.int64)).to(p.device)
    dist = popcount32(mism).sum(dim=-1)
    return torch.where(valid, dist, L + 1).to(torch.int32)


def _check_verify(text_words, pos, qwords, valid) -> None:
    if text_words.dtype != torch.int32 or text_words.dim() != 1 or text_words.numel() < 1:
        raise ValueError(f"text words must be int32 [nw >= 1], got {text_words.dtype} {tuple(text_words.shape)}")
    if pos.dtype != torch.int64 or pos.dim() != 2:
        raise ValueError(f"pos must be int64 [B, C], got {pos.dtype} {tuple(pos.shape)}")
    if valid.dtype != torch.bool or valid.shape != pos.shape:
        raise ValueError(f"valid must be bool {tuple(pos.shape)}, got {valid.dtype} {tuple(valid.shape)}")
    if qwords.dtype != torch.int64 or qwords.dim() != 2 or qwords.shape[0] != pos.shape[0]:
        raise ValueError(f"read words must be int64 [{pos.shape[0]}, W], got {qwords.dtype} {tuple(qwords.shape)}")
    tensors = (text_words, pos, qwords, valid)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("text words, pos, read words and valid must be contiguous")
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devices))}")
    if pos.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the verify runs on cpu or cuda tensors, got {pos.device}")


def hamming_to_text(text_words, pos, qwords, valid, L: int) -> torch.Tensor:
    """Hamming distance of every valid candidate lane (the contract of
    ``hamming_to_text_reference``; read b = lane // C).

    CPU tensors take the plain version; CUDA tensors launch K5, and a
    kernel that cannot be built or launched raises."""
    _check_verify(text_words, pos, qwords, valid)
    if qwords.shape[1] != -(-L // 16):
        raise ValueError(f"{qwords.shape[1]} read words for L={L}")
    if pos.device.type == "cpu":
        return hamming_to_text_reference(text_words, pos, qwords, valid, L)
    out = torch.empty(pos.shape, dtype=torch.int32, device=pos.device)
    if pos.numel() == 0:
        return out
    global LAUNCHES
    from tpufm_torch import kernels

    lib = kernels.library("hamming_verify")
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream(pos.device).cuda_stream
        err = lib.tpufm_hamming_verify(
            text_words.data_ptr(), text_words.shape[0], pos.data_ptr(), qwords.data_ptr(),
            valid.data_ptr(), out.data_ptr(), pos.numel(), pos.shape[1], qwords.shape[1], L, stream,
        )
    if err:
        raise RuntimeError(f"hamming_verify kernel launch failed: {kernels.error_string('hamming_verify', err)}")
    LAUNCHES += 1
    return out


def compact_hits(cand: torch.Tensor, accept: torch.Tensor, max_hits: int):
    """(int64 [B, max_hits] the first max_hits accepted candidates of each
    read in order, SENTINEL-padded; int64 [B] each read's accept count).
    The discarded column max_hits takes duplicate indices, which scatter_
    resolves in no fixed order on CUDA; it is dropped, so the kept columns
    do not depend on it."""
    B = cand.shape[0]
    slot = accept.cumsum(dim=1) - 1
    slot = torch.where(accept & (slot < max_hits), slot, max_hits)
    out = torch.full((B, max_hits + 1), SENTINEL, dtype=torch.int64, device=cand.device)
    out.scatter_(1, slot, torch.where(accept, cand, SENTINEL))
    return out[:, :max_hits], accept.sum(dim=1)


def sorted_unique(cand: torch.Tensor):
    """(cand sorted per row, bool: the first of each run of equal values and
    not SENTINEL), the sort-and-neighbour-dedup of seed.py:257-266."""
    cand = cand.sort(dim=1).values
    first = torch.ones_like(cand[:, :1], dtype=torch.bool)
    uniq = (cand != SENTINEL) & torch.cat([first, cand[:, 1:] != cand[:, :-1]], dim=1)
    return cand, uniq


def seed_extend_oracle(codes, queries, mismatches: int):
    """Naive sliding-window ground truth: (counts int64 [B], positions: a
    list of ascending uint32 arrays, one a read). Test scale only."""
    codes = np.asarray(codes, dtype=np.uint8)
    queries = np.asarray(queries, dtype=np.uint8)
    wins = np.lib.stride_tricks.sliding_window_view(codes, queries.shape[1])
    counts, positions = [], []
    for q in queries:
        hit = np.flatnonzero((wins != q[None, :]).sum(axis=1) <= mismatches)
        counts.append(hit.size)
        positions.append(hit.astype(np.uint32))
    return np.asarray(counts, dtype=np.int64), positions


class SeedEngine(torch.nn.Module):
    """The tables every seed-and-extend engine holds on one device: the
    search tables (``search_engine``, K1), the sampled-SA locate tables
    (``locate_engine``, K4) and the 2-bit packed text (``text_words``), and
    the SEED + LOCATE front end they share (``seed_intervals``, then
    ``seed_positions``). ``index``
    may be a ``SearchLocateEngine``: the engine then runs on its search and
    locate tables, not copied, with its LUT (``loc``, ``lut_m`` and
    ``device`` are not used), as the mesh engines share one table set a
    device among their position sources."""

    def __init__(self, index, loc, text, seed_hits: int, max_hits: int, lut_m: int,
                 device: str | torch.device):
        super().__init__()
        if seed_hits < 1 or max_hits < 1:
            raise ValueError(f"seed_hits and max_hits must be >= 1, got {seed_hits}, {max_hits}")
        if isinstance(index, SearchLocateEngine):
            self.search_engine, self.locate_engine = index.search_engine, index.locate_engine
        else:
            self.search_engine = SearchEngine(index, device, lut_m=lut_m, layout="fused")
            self.locate_engine = LocateEngine(loc, self.search_engine.device)
        text = np.asarray(text)  # 2-bit codes, or words already packed
        if text.dtype != np.uint32:
            text = pack_text_words(text)
        self.register_buffer("text_words", _words(text, self.search_engine.device))
        self.seed_hits, self.max_hits = seed_hits, max_hits
        self.bwtsize = self.search_engine.bwtsize

    @property
    def device(self) -> torch.device:
        return self.search_engine.device

    def seed_intervals(self, queries: torch.Tensor, S: int, what: str, step=None):
        """SEED (seed.py:124): S disjoint fixed-offset seeds of every read
        through the exact search: (iv int64 [B, S, 2] their intervals, offs
        the S seed offsets). Issues device work only."""
        eng = self.search_engine
        B, L = queries.shape
        k = eng.k
        Ls = (L // S) // k * k
        if Ls < k:
            raise ValueError(
                f"read length {L} too short for {what} at k={k}: "
                f"needs {S} disjoint seeds of >= {k} bases"
            )
        offs = [i * Ls for i in range(S)]
        seeds = torch.stack([queries[:, o:o + Ls] for o in offs], dim=1).reshape(B * S, Ls)
        # the LUT starts a seed only when the seed is at least as long
        use_lut = bool(eng.lut_m) and Ls >= eng.lut_m
        return eng.search_device(seeds, step, use_lut=use_lut).view(B, S, 2), offs

    def seed_positions(self, iv: torch.Tensor, walk=None):
        """LOCATE: each seed interval's (``seed_intervals``, iv [B, S, 2])
        first seed_hits rows through the walk: (pos int64 [B, S, seed_hits]
        seed text positions, 0 outside the interval; seedok bool [B, S,
        seed_hits] lanes inside it; overflow bool [B] some interval wider
        than seed_hits). Reads the count of rows to walk back to the host."""
        H = self.seed_hits
        lo = iv[..., 0]
        width = (iv[..., 1] - lo) & FULL
        overflow = (width > H).any(dim=1)
        cols = torch.arange(H, device=iv.device)
        seedok = cols < width.clamp(max=H)[..., None]
        rows = torch.where(seedok, lo[..., None] + cols, 0)
        pos = locate_compacted(lambda p: self.locate_engine.walk(p, walk), rows, seedok)
        return pos, seedok, overflow

    def _stream(self, queries, wave: int | None, fn):
        """(positions uint32 [B, max_hits], counts uint32 [B], overflow bool
        [B]) of ``fn`` (a wave of reads on the device -> the three as
        int64 tensors) over host reads, in waves of ``wave`` (default WAVE)."""
        queries = np.require(queries, np.uint8, ["C", "W"])
        out = stream_waves(queries, wave or self.WAVE, lambda q: hits_block(*fn(q)), self.device,
                           (self.max_hits + 2,))
        return split_hits(out, self.max_hits)


def hits_block(pos: torch.Tensor, counts: torch.Tensor, overflow: torch.Tensor) -> torch.Tensor:
    """The three results of a wave as one int64 [B, max_hits + 2] block
    (one copy to the host): positions, count, overflow."""
    return torch.cat([pos, counts[:, None], overflow[:, None].to(torch.int64)], dim=1)


def split_hits(out: np.ndarray, max_hits: int):
    """uint32 [B, max_hits + 2] host blocks (``hits_block``) -> (positions
    uint32 [B, max_hits], counts uint32 [B], overflow bool [B])."""
    return (np.ascontiguousarray(out[:, :max_hits]), np.ascontiguousarray(out[:, max_hits]),
            out[:, max_hits + 1].astype(bool))


class SeedExtendEngine(SeedEngine):
    """Approximate matching at Hamming distance m >= 1 on one device.

    index: a KStepFMIndex or ready ``Tables`` (an AltCountersIndex raises
    tpufm's ValueError: the search is the fused layout's); loc: a LocateIndex or ``LocateTables`` over the
    same text; text: its 2-bit codes, or ``pack_text_words`` of them. The
    methods' ``step``, ``walk`` and ``verify``: None runs this engine's
    kernels (K1, K4, K5); the plain ``lf_round_reference``,
    ``locate_walk_reference`` and ``hamming_to_text_reference`` replace
    them.
    """

    #: reads per wave: each read carries m+1 search lanes and
    #: (m+1)*seed_hits walk and verify lanes (the JAX engine's; not tuned here)
    WAVE = 1 << 16

    def __init__(
        self,
        index: KStepFMIndex | Tables,
        loc: LocateIndex | LocateTables,
        text,
        mismatches: int,
        seed_hits: int = 32,
        max_hits: int = 4,
        lut_m: int = 0,
        device: str | torch.device = "cuda",
    ):
        if mismatches < 1:
            raise ValueError("SeedExtendEngine is for mismatches >= 1")
        super().__init__(index, loc, text, seed_hits, max_hits, lut_m, resolve_device(device))
        self.mismatches = mismatches

    def seeds(self, queries: torch.Tensor, step=None):
        """The m+1 seed intervals of a wave (``seed_intervals``)."""
        m = self.mismatches
        return self.seed_intervals(queries, m + 1, f"{m} mismatches", step)

    def candidates(self, queries: torch.Tensor, step=None, walk=None, seeds=None):
        """SEED + LOCATE of a wave on the device: (cand int64 [B, C] candidate
        starts sorted per read, SENTINEL where none; uniq bool [B, C] the
        distinct ones; qwords int64 [B, W] the reads' packed words;
        overflow bool [B]), C = (m+1) * seed_hits (seed.py:241-266).
        ``seeds``: ``seeds(queries)`` when already issued."""
        B, L = queries.shape
        iv, offs = seeds or self.seeds(queries, step)
        pos, seedok, overflow = self.seed_positions(iv, walk)
        offv = torch.tensor(offs, device=pos.device)[None, :, None]
        n_text = self.bwtsize - 1
        ok = seedok & (pos >= offv) & (pos + (L - offv) <= n_text)
        cand, uniq = sorted_unique(torch.where(ok, pos - offv, SENTINEL).reshape(B, -1))
        return cand, uniq, pack_query_words(queries), overflow

    def locate_approx_device(self, queries: torch.Tensor, step=None, walk=None, verify=None, seeds=None):
        """uint8 [B, L] reads on this engine's device -> (positions int64
        [B, max_hits] ascending, SENTINEL-padded; counts int64 [B] distinct
        positions within distance m; overflow bool [B])."""
        cand, uniq, qwords, overflow = self.candidates(queries, step, walk, seeds)
        L = queries.shape[1]
        dist = (verify or hamming_to_text)(self.text_words, torch.where(uniq, cand, 0), qwords, uniq, L)
        pos, counts = compact_hits(cand, uniq & (dist <= self.mismatches), self.max_hits)
        return pos, counts, overflow

    def locate_approx(self, queries, wave: int | None = None, step=None, walk=None, verify=None):
        """uint8 [B, L] host reads -> (positions uint32 [B, max_hits]
        ascending, 0xFFFFFFFF padded; counts uint32 [B]; overflow bool
        [B]), in waves of ``wave`` reads."""
        return self._stream(queries, wave, lambda q: self.locate_approx_device(q, step, walk, verify))

    def count_approx(self, queries, wave: int | None = None, step=None, walk=None, verify=None):
        """uint8 [B, L] host reads -> (counts uint32 [B], overflow bool [B]):
        distinct text positions within Hamming distance m, exact where
        overflow is False and a lower bound where it is True."""
        _, counts, overflow = self.locate_approx(queries, wave, step, walk, verify)
        return counts, overflow
