"""Edit-distance (indel-aware) seed-and-extend on one device: pigeonhole
seeds and a batched multi-word Myers bit-vector verifier.

Counterpart of tpufm/engine/edit.py: ``build_peq`` (:63),
``make_myers_verify_fn`` (:105), ``make_edit_extend_fn`` (:228),
``edit_extend_oracle`` (:359) and ``EditExtendEngine`` (:382). The seed
and locate passes are the seed engine's (E+1 disjoint seeds; an edit
touches at most one). A seed hit anchors a = position - offset, exact only
up to the net indel shift before the chunk, so the occurrence start lies in
[a-E, a+E]. The verify (K6, ``myers_verify``) scans each candidate's
L+3E-character window back to front with the reversed read: after step t
the semi-global Myers score is min_e edit(read, text[s:e]) for the start
s = window end - t, and the scan keeps the least distance over [lo, hi]
and the leftmost start that reaches it.

Output: up to max_hits distinct start sites a read, each the leftmost
least-distance start of its candidate window and within E edits, the
per-read site count, and the seed engine's overflow flag (the site list is
a lower bound where it is set). tpufm compacts the verify lanes into a
fixed budget only because its shapes are static, and its ``chars="pre"``
is a TPU layout probe; neither is carried here, with the same results.

``myers_verify`` is the wrapper of K6 (tpufm_torch/csrc/myers_verify.cu):
a CPU tensor takes the plain version ``myers_verify_reference``; a CUDA
tensor launches the kernel or raises. JAX's scan is plain jnp (no
``pallas_call``), so K6 is a new kernel of the port.
"""

from __future__ import annotations

import numpy as np
import torch

from tpufm_torch.bitops import FULL, from_u32_bits
from tpufm_torch.device import resolve_device
from tpufm_torch.engine.locate import LocateTables
from tpufm_torch.engine.seed import SENTINEL, SeedEngine, compact_hits, sorted_unique
from tpufm_torch.engine.tables import Tables
from tpufm_torch.host.index import AltCountersIndex, KStepFMIndex
from tpufm_torch.host.locate import LocateIndex

#: kernel launches made by ``myers_verify`` in this process (plain-path
#: calls on CPU tensors do not count)
LAUNCHES = 0
#: the widest read (in 32-bit words) whose scan state K6 holds in registers;
#: wider reads keep it in a scratch buffer
MAX_REG_WORDS = 8


def build_peq(queries: torch.Tensor, W: int) -> torch.Tensor:
    """uint8 [..., L] reads -> int64 [..., 4, W] Myers match masks: bit i of
    word i // 32 of plane c is set iff read[i] == c (LSB = read[0]). Bits
    past L stay 0 (the score is read at bit L-1), as the pad value 255
    matches no plane."""
    L = queries.shape[-1]
    q = torch.nn.functional.pad(queries, (0, W * 32 - L), value=255)
    q = q.reshape(*queries.shape[:-1], W, 32)
    bit = torch.ones(32, dtype=torch.int64, device=queries.device) << torch.arange(32, device=queries.device)
    return torch.stack([torch.where(q == c, bit, 0).sum(dim=-1) for c in range(4)], dim=-2)


def myers_verify_reference(text_words, n_text: int, peq, lo, hi, valid, L: int, E: int):
    """Plain PyTorch K6 on any device, the scan of edit.py:105-225 with
    explicit ripple carries: (dist int32 [B, C], the least start-anchored
    edit distance over starts [lo, hi], L+1 where none was found or the
    lane is not ``valid``; start int64 [B, C], the leftmost start reaching
    it, 0xFFFFFFFF where none). text_words: int32 [nw] packed text of
    ``n_text`` bases; peq: int64 [B, 4, W] from the reversed read; lo, hi:
    int64 [B, C] (lo is the window start)."""
    TL = L + 3 * E
    W = peq.shape[-1]
    WG = TL // 16 + 2  # words covering any 16-alignment of the window
    msw, msb = (L - 1) // 32, (L - 1) % 32
    dev = lo.device
    B, C = lo.shape
    ws = lo
    base = ws // 16
    widx = (base[..., None] + torch.arange(WG, device=dev)).clamp(max=text_words.shape[0] - 1)
    words = from_u32_bits(text_words[widx])  # [B, C, WG]
    woff = ws % 16
    planes = peq[:, None].expand(B, C, 4, W)
    vp = [torch.full((B, C), (1 << min(32, L - 32 * w)) - 1, dtype=torch.int64, device=dev) for w in range(W)]
    vn = [torch.zeros((B, C), dtype=torch.int64, device=dev) for _ in range(W)]
    score = torch.full((B, C), L, dtype=torch.int64, device=dev)
    best = torch.full((B, C), L + 1, dtype=torch.int64, device=dev)
    bstart = torch.full((B, C), SENTINEL, dtype=torch.int64, device=dev)
    for t in range(TL):
        j = TL - 1 - t  # window character of this step
        rel = woff + j
        w32 = words.gather(-1, (rel // 16)[..., None])[..., 0]
        c = (w32 >> (2 * (15 - rel % 16))) & 3
        inb = ws + j < n_text
        eq = [torch.where(inb, planes[..., w].gather(-1, c[..., None])[..., 0], 0) for w in range(W)]
        x = [eq[w] | vn[w] for w in range(W)]
        d0, carry = [], 0
        for w in range(W):  # vp + (x & vp), word by word with the carry
            total = vp[w] + (x[w] & vp[w]) + carry
            carry = total >> 32
            d0.append(((total & FULL) ^ vp[w]) | x[w])
        hn = [vp[w] & d0[w] for w in range(W)]
        hp = [vn[w] | ((vp[w] | d0[w]) ^ FULL) for w in range(W)]
        score = score + ((hp[msw] >> msb) & 1) - ((hn[msw] >> msb) & 1)
        xs = [((hp[w] << 1) & FULL) | (hp[w - 1] >> 31 if w else 0) for w in range(W)]
        hns = [((hn[w] << 1) & FULL) | (hn[w - 1] >> 31 if w else 0) for w in range(W)]
        vn = [xs[w] & d0[w] for w in range(W)]
        vp = [hns[w] | ((xs[w] | d0[w]) ^ FULL) for w in range(W)]
        s = ws + j  # the candidate start
        upd = valid & (s <= hi) & (score <= best)
        best = torch.where(upd, score, best)
        bstart = torch.where(upd, s, bstart)
    return best.to(torch.int32), bstart


def _check_myers(text_words, peq, lo, hi, valid, L: int, E: int) -> None:
    if text_words.dtype != torch.int32 or text_words.dim() != 1 or text_words.numel() < 1:
        raise ValueError(f"text words must be int32 [nw >= 1], got {text_words.dtype} {tuple(text_words.shape)}")
    if L < 1 or E < 0:
        raise ValueError(f"need L >= 1 and E >= 0, got L={L} E={E}")
    if lo.dtype != torch.int64 or lo.dim() != 2 or hi.dtype != torch.int64 or hi.shape != lo.shape:
        raise ValueError(f"lo and hi must be int64 [B, C], got {tuple(lo.shape)} and {tuple(hi.shape)}")
    if valid.dtype != torch.bool or valid.shape != lo.shape:
        raise ValueError(f"valid must be bool {tuple(lo.shape)}, got {valid.dtype} {tuple(valid.shape)}")
    W = -(-L // 32)
    if peq.dtype != torch.int64 or tuple(peq.shape) != (lo.shape[0], 4, W):
        raise ValueError(f"peq must be int64 [{lo.shape[0]}, 4, {W}], got {peq.dtype} {tuple(peq.shape)}")
    tensors = (text_words, peq, lo, hi, valid)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("text words, peq, lo, hi and valid must be contiguous")
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devices))}")
    if lo.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the verify runs on cpu or cuda tensors, got {lo.device}")


def myers_verify(text_words, n_text: int, peq, lo, hi, valid, L: int, E: int):
    """(dist, start) of every candidate lane (the contract of
    ``myers_verify_reference``; read b = lane // C).

    CPU tensors take the plain version; CUDA tensors launch K6, and a
    kernel that cannot be built or launched raises."""
    _check_myers(text_words, peq, lo, hi, valid, L, E)
    if lo.device.type == "cpu":
        return myers_verify_reference(text_words, n_text, peq, lo, hi, valid, L, E)
    dist = torch.empty(lo.shape, dtype=torch.int32, device=lo.device)
    start = torch.empty_like(lo)
    if lo.numel() == 0:
        return dist, start
    global LAUNCHES
    from tpufm_torch import kernels

    W = peq.shape[-1]
    lib = kernels.library("myers_verify")
    scratch, slots = None, 0
    if W > MAX_REG_WORDS:  # a slot a thread of K6's grid, not a lane
        slots = lib.tpufm_myers_verify_slots(lo.numel())
        scratch = torch.empty((2, W, slots), dtype=torch.int32, device=lo.device)
    with torch.cuda.device(lo.device):
        stream = torch.cuda.current_stream(lo.device).cuda_stream
        err = lib.tpufm_myers_verify(
            text_words.data_ptr(), text_words.shape[0], n_text, peq.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            valid.data_ptr(), dist.data_ptr(), start.data_ptr(), lo.numel(), lo.shape[1], W, L, E,
            None if scratch is None else scratch.data_ptr(), slots, stream,
        )
    if err:
        raise RuntimeError(f"myers_verify kernel launch failed: {kernels.error_string('myers_verify', err)}")
    LAUNCHES += 1
    return dist, start


def edit_extend_oracle(codes, queries, edits: int):
    """Ground truth (test scale): int64 [B, n], dist[b, s] = the start-anchored
    free-end edit distance min_e edit(read b, codes[s:e]) at every text start
    s, by the reversed semi-global DP (column-vectorised numpy)."""
    codes = np.asarray(codes, dtype=np.uint8)
    queries = np.asarray(queries, dtype=np.uint8)
    B, L = queries.shape
    n = codes.shape[0]
    R = queries[:, ::-1]
    T = codes[::-1]
    ar = np.arange(L + 1)
    col = np.broadcast_to(ar, (B, L + 1)).copy()
    dist = np.full((B, n), L, dtype=np.int64)
    for j in range(1, n + 1):
        sub = (R != T[j - 1]).astype(np.int64)
        t = np.minimum(col[:, :-1] + sub, col[:, 1:] + 1)
        c = np.concatenate([np.zeros((B, 1), np.int64), t], axis=1)
        col = np.minimum.accumulate(c - ar, axis=1) + ar
        dist[:, n - j] = col[:, L]
    return dist


def windowed_edit_dist(codes: torch.Tensor, reads: torch.Tensor, starts: torch.Tensor, edits: int) -> torch.Tensor:
    """int64 [P]: ``edit_extend_oracle``'s distance of read p at start
    ``starts[p]``, by the same reversed DP run only over the window
    codes[s : s + L + E] (the text past its end matching nothing), on any
    device. Where the full distance is <= E the two are equal, and where it
    is > E so is this: an alignment ending past s + L + E costs more than
    E edits, and a character past the text end only raises a cost. So
    ``<= E`` verdicts equal the full oracle's. codes uint8 [n]; reads uint8
    [P, L]; starts int64 [P]."""
    P, L = reads.shape
    span = L + edits
    idx = starts[:, None] + torch.arange(span, device=starts.device)
    inside = idx < codes.shape[0]
    window = torch.where(inside, codes[idx.clamp(max=codes.shape[0] - 1)].to(torch.int64), 4)
    R = reads.flip(-1).to(torch.int64)
    ar = torch.arange(L + 1, device=reads.device)
    col = ar.expand(P, L + 1)
    zero = torch.zeros((P, 1), dtype=torch.int64, device=reads.device)
    for j in range(span):  # the window reversed: its last character first
        sub = (R != window[:, span - 1 - j, None]).to(torch.int64)
        t = torch.minimum(col[:, :-1] + sub, col[:, 1:] + 1)
        col = torch.cummin(torch.cat([zero, t], dim=1) - ar, dim=1).values + ar
    return col[:, L]


class EditExtendEngine(SeedEngine):
    """Edit-distance matching at E >= 1 on one device: the seed engine's
    tables (search tables, locate tables, packed text), verified by the
    Myers scan (K6). ``step``, ``walk`` and ``verify`` of the methods: None
    runs this engine's kernels (K1, K4, K6); the plain
    ``lf_round_reference``, ``locate_walk_reference`` and
    ``myers_verify_reference`` replace them.
    """

    #: reads per wave: each read carries E+1 search lanes and (E+1) *
    #: seed_hits scan lanes (the JAX engine's; not tuned here)
    WAVE = 1 << 13

    def __init__(
        self,
        index: KStepFMIndex | AltCountersIndex | Tables,
        loc: LocateIndex | LocateTables,
        text,
        edits: int,
        seed_hits: int = 32,
        max_hits: int = 4,
        lut_m: int = 0,
        device: str | torch.device = "cuda",
    ):
        if edits < 1:
            raise ValueError("EditExtendEngine is for edits >= 1")
        super().__init__(index, loc, text, seed_hits, max_hits, lut_m, resolve_device(device))
        self.edits = edits

    def candidates(self, queries: torch.Tensor, step=None, walk=None):
        """SEED + LOCATE of a wave on the device (edit.py:269-300): (lo, hi
        int64 [B, C] each candidate's start range, 0 where not valid; valid
        bool [B, C]; peq int64 [B, 4, W] of the reversed reads; overflow bool
        [B]), C = (E+1) * seed_hits. Anchor a = pos - offset, b = a + E:
        valid iff the seed lane is and -E <= a <= n - 1 + E; lo = max(a - E,
        0), hi = min(a + E, n - 1)."""
        B, L = queries.shape
        E = self.edits
        pos, seedok, overflow, offs = self.seed_positions(queries, E + 1, f"{E} edits", step, walk)
        n_text = self.bwtsize - 1
        offv = torch.tensor(offs, device=pos.device)[None, :, None]
        b = pos + E - offv
        valid = seedok & (b >= 0) & (b <= n_text - 1 + 2 * E)
        lo = torch.where(valid, b.clamp(min=2 * E) - 2 * E, 0).reshape(B, -1)
        hi = torch.where(valid, b.clamp(max=n_text - 1), 0).reshape(B, -1)
        peq = build_peq(queries.flip(-1), -(-L // 32))
        return lo, hi, valid.reshape(B, -1), peq, overflow

    def locate_edits_device(self, queries: torch.Tensor, step=None, walk=None, verify=None):
        """uint8 [B, L] reads on this engine's device -> (starts int64 [B,
        max_hits] ascending distinct sites, SENTINEL-padded; counts int64
        [B]; overflow bool [B])."""
        lo, hi, valid, peq, overflow = self.candidates(queries, step, walk)
        dist, start = (verify or myers_verify)(self.text_words, self.bwtsize - 1, peq, lo, hi, valid,
                                              queries.shape[1], self.edits)
        cand, uniq = sorted_unique(torch.where(valid & (dist <= self.edits), start, SENTINEL))
        sites, counts = compact_hits(cand, uniq, self.max_hits)
        return sites, counts, overflow

    def locate_edits(self, queries, wave: int | None = None, step=None, walk=None, verify=None):
        """uint8 [B, L] host reads -> (starts uint32 [B, max_hits] ascending
        distinct alignment start sites, 0xFFFFFFFF padded; counts uint32
        [B]; overflow bool [B]), in waves of ``wave`` reads."""
        return self._stream(queries, wave, lambda q: self.locate_edits_device(q, step, walk, verify))
