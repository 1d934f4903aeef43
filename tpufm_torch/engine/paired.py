"""Paired-end read placement on one device: FR pairs under an insert-size
window.

Counterpart of tpufm/engine/paired.py: ``make_pair_fn`` (:35),
``pair_oracle`` (:109) and ``PairedEndEngine`` (:141). A proper pair on the
plus strand places R1 forward at p1 and the reverse complement of R2 at p2
with max(imin, L2) <= p2 + L2 - p1 <= imax; on the minus strand rc(R1) at q1
and R2 forward at q2 with max(imin, L1) <= q1 + L1 - q2 <= imax. Both
mates' both strands ride one position-engine batch of 4B reads (two
batches of 2B when L1 != L2); the join is a [H1, H2] outer comparison per
read pair and strand, then the cumsum/scatter compaction to max_pairs. The
join is plain PyTorch (``pair_join``): a few hundred operations a pair, as
tpufm leaves it to jnp. Positions come from one of four sources: the
fused search+locate (exact), the Hamming <= 1 locate, the seed engine
(m >= 2) or the edit engine (E >= 1); with a ``mesh``, from the
``DataParallelSearchLocate`` over it (tpufm/engine/paired.py:173-181),
whose approximate sources take the text with every call, and the join runs
on the mesh's first device.
"""

from __future__ import annotations

import numpy as np
import torch

from tpufm_torch.bitops import FULL
from tpufm_torch.device import resolve_device
from tpufm_torch.engine.edit import EditExtendEngine
from tpufm_torch.engine.seed import SENTINEL, SeedExtendEngine
from tpufm_torch.engine.search_locate import SearchLocateEngine
from tpufm_torch.host.seqio import reverse_complement
from tpufm_torch.parallel.locate import DataParallelSearchLocate


def _strand_pairs(left: torch.Tensor, right: torch.Tensor, Llast: int, imin: int, imax: int) -> torch.Tensor:
    """bool [B, H1, H2]: left start i and right start j make a proper pair,
    max(imin, Llast) <= right + Llast - left <= imax in uint32 arithmetic,
    so that a crossing pair (right + Llast < left) wraps far above imax, as
    it does in tpufm."""
    frag = (right[:, None, :] + Llast - left[:, :, None]) & FULL
    ok = (left != SENTINEL)[:, :, None] & (right != SENTINEL)[:, None, :]
    return ok & (frag >= max(imin, Llast)) & (frag <= imax)


def pair_join(pos1f, pos2r, pos1r, pos2f, L1: int, L2: int, imin: int, imax: int, max_pairs: int):
    """The pairing pass (paired.py:35-106) on int64 position rows [B, H]
    (SENTINEL-padded) of R1 forward, rc(R2), rc(R1) and R2 forward ->
    (pairs int64 [B, max_pairs, 2] (leftmost mate start, rightmost mate
    start), SENTINEL-padded; strand uint8 [B, max_pairs], 0 = R1 on plus,
    1 = R1 on minus, 2 = padding; counts int64 [B] proper pairs found,
    which may exceed max_pairs). Plus-strand pairs come first, each strand
    in (left, right) row-major order."""
    B, P = pos1f.shape[0], max_pairs
    ok_p = _strand_pairs(pos1f, pos2r, L2, imin, imax)  # R1 left, rc(R2) right
    ok_m = _strand_pairs(pos2f, pos1r, L1, imin, imax)  # R2 left, rc(R1) right

    def flat(ok, left, right):
        return (ok.reshape(B, -1), left[:, :, None].expand(ok.shape).reshape(B, -1),
                right[:, None, :].expand(ok.shape).reshape(B, -1))

    okp, lp, rp = flat(ok_p, pos1f, pos2r)
    okm, lm, rm = flat(ok_m, pos2f, pos1r)
    ok = torch.cat([okp, okm], dim=1)
    lft = torch.cat([lp, lm], dim=1)
    rgt = torch.cat([rp, rm], dim=1)
    st = torch.cat([torch.zeros_like(okp, dtype=torch.uint8), torch.ones_like(okm, dtype=torch.uint8)], dim=1)
    # kept pairs go to columns 0..P-1 in order, the rest to the discarded
    # column P, whose duplicate indices scatter_ resolves in no fixed order
    # on CUDA; it is dropped, so the kept columns do not depend on it
    slot = ok.cumsum(dim=1) - 1
    slot = torch.where(ok & (slot < P), slot, P)
    pairs = torch.full((B, P + 1, 2), SENTINEL, dtype=torch.int64, device=ok.device)
    pairs[..., 0].scatter_(1, slot, torch.where(ok, lft, SENTINEL))
    pairs[..., 1].scatter_(1, slot, torch.where(ok, rgt, SENTINEL))
    strand = torch.full((B, P + 1), 2, dtype=torch.uint8, device=ok.device)
    strand.scatter_(1, slot, torch.where(ok, st, 2).to(torch.uint8))
    return pairs[:, :P], strand[:, :P], ok.sum(dim=1)


def _occurrences(text: torch.Tensor, read: np.ndarray) -> np.ndarray:
    """Start positions of exact occurrences of ``read`` in ``text`` (uint8
    [n] on any device), by a scan of every window."""
    windows = text.unfold(0, read.shape[0], 1)
    hit = (windows == torch.from_numpy(np.ascontiguousarray(read)).to(text.device)).all(dim=1)
    return hit.nonzero()[:, 0].cpu().numpy()


def pair_oracle(codes, r1, r2, imin: int, imax: int, device: str | torch.device = "cpu"):
    """Naive ground truth: all proper FR pairs of each read pair as a list
    of (left, right, strand) triples, strand 0 = R1 on plus; each mate's
    occurrences by a scan of every text window on ``device`` (no index)."""
    text = torch.from_numpy(np.require(codes, np.uint8, ["C", "W"])).to(resolve_device(device))
    r1 = np.asarray(r1, np.uint8)
    r2 = np.asarray(r2, np.uint8)
    L1, L2 = r1.shape[1], r2.shape[1]
    out = []
    for a, b in zip(r1, r2):
        triples = []
        for p1 in _occurrences(text, a):  # R1 plus
            for p2 in _occurrences(text, reverse_complement(b[None])[0]):
                f = p2 + L2 - p1
                if L2 <= f and imin <= f <= imax:
                    triples.append((int(p1), int(p2), 0))
        for q2 in _occurrences(text, b):  # R1 minus
            for q1 in _occurrences(text, reverse_complement(a[None])[0]):
                f = q1 + L1 - q2
                if L1 <= f and imin <= f <= imax:
                    triples.append((int(q2), int(q1), 1))
        out.append(triples)
    return out


class PairedEndEngine(torch.nn.Module):
    """Paired-end placement on one device, or over a mesh.

    Runs [R1; rc(R2); rc(R1); R2] as one 4B-read batch through a position
    source and joins the four position sets on the device. The source:
    ``SearchLocateEngine.search_locate`` (exact), ``locate_mismatch``
    (mismatches=1), ``SeedExtendEngine`` (mismatches >= 2, needs ``text``)
    or ``EditExtendEngine`` (edits >= 1, needs ``text``). A mate whose
    position row may have been cut (its interval wider than max_hits, its
    site count past max_hits, a seed overflow, or for mismatches=1 a full
    row) flags its pair ``overflow``: that pair's list is a lower bound.
    ``step``, ``walk`` and ``verify`` of ``pair``: None runs the kernels;
    the plain versions replace them. ``mesh``: every source split over
    that mesh (``DataParallelSearchLocate``; ``device`` is not used).
    """

    def __init__(self, index, loc, imin: int, imax: int, max_hits: int = 8, max_pairs: int = 4,
                 lut_m: int = 0, mismatches: int = 0, seed_hits: int = 32, text=None, edits: int = 0,
                 device: str | torch.device = "cuda", mesh=None):
        super().__init__()
        if imin > imax:
            raise ValueError(f"insert range empty: [{imin}, {imax}]")
        if mismatches and edits:
            raise ValueError("mismatches and edits are different distance models; pass one")
        if (mismatches >= 2 or edits) and text is None:
            raise ValueError(
                "mismatches >= 2 / edits pairing needs the reference text "
                "(2-bit codes) for the verify pass"
            )
        self.mismatches, self.edits, self.seed_hits = mismatches, edits, seed_hits
        self.mesh, self.text = mesh, text
        if mesh is not None:
            self.source = DataParallelSearchLocate(index, loc, mesh, max_hits=max_hits, lut_m=lut_m)
        elif edits:
            self.source = EditExtendEngine(index, loc, text, edits=edits, seed_hits=seed_hits,
                                           max_hits=max_hits, lut_m=lut_m, device=resolve_device(device))
        elif mismatches >= 2:
            self.source = SeedExtendEngine(index, loc, text, mismatches=mismatches, seed_hits=seed_hits,
                                           max_hits=max_hits, lut_m=lut_m, device=resolve_device(device))
        else:
            self.source = SearchLocateEngine(index, loc, resolve_device(device), max_hits=max_hits, lut_m=lut_m)
        self.imin, self.imax = imin, imax
        self.max_hits, self.max_pairs = max_hits, max_pairs

    @property
    def device(self) -> torch.device:
        """Where the join runs: the source's device, or the mesh's first."""
        return self.source.device if self.mesh is None else self.mesh.devices[0]

    def _positions(self, batch, wave, step, walk, verify):
        """uint8 [N, L] host reads -> (positions uint32 [N, max_hits],
        overflow bool [N]) from the configured source (paired.py:197-239)."""
        cap = np.uint32(self.max_hits)
        # the mesh source takes the text and the distance with every call
        approx = () if self.mesh is None else (self.text, self.edits or self.mismatches, self.seed_hits)
        if self.edits:
            pos, cnt, ovf = self.source.locate_edits(batch, *approx, wave=wave, step=step, walk=walk, verify=verify)
            return pos, ovf | (cnt > cap)
        if self.mismatches >= 2:
            pos, cnt, ovf = self.source.locate_approx(batch, *approx, wave=wave, step=step, walk=walk,
                                                      verify=verify)
            return pos, ovf | (cnt > cap)
        if self.mismatches == 1:
            pos = self.source.locate_mismatch(batch, wave, step, walk)
            # no truncation signal here: a full row may have been cut
            return pos, (pos != np.uint32(SENTINEL)).all(axis=1)
        iv, pos = self.source.search_locate(batch, wave, step, walk)
        return pos, (iv[:, 1] - iv[:, 0]) > cap

    def pair(self, r1, r2, wave: int | None = None, step=None, walk=None, verify=None):
        """R1 uint8 [B, L1], R2 uint8 [B, L2] host reads -> (pairs uint32 [B,
        max_pairs, 2] (left, right) starts, strand uint8 [B, max_pairs] (0
        = R1 plus, 1 = R1 minus, 2 = padding), counts uint32 [B], overflow
        bool [B])."""
        r1 = np.asarray(r1, np.uint8)
        r2 = np.asarray(r2, np.uint8)
        if r1.shape[0] != r2.shape[0]:
            raise ValueError("R1/R2 batches differ in length")
        B, L1, L2 = r1.shape[0], r1.shape[1], r2.shape[1]
        if B == 0:
            return (np.zeros((0, self.max_pairs, 2), np.uint32), np.zeros((0, self.max_pairs), np.uint8),
                    np.zeros(0, np.uint32), np.zeros(0, bool))
        run = (lambda batch: self._positions(batch, wave, step, walk, verify))
        if L1 == L2:
            # both mates, both strands: one 4B-read batch
            pos, ovf = run(np.concatenate([r1, reverse_complement(r2), reverse_complement(r1), r2]))
            p1f, p2r, p1r, p2f = pos[:B], pos[B:2 * B], pos[2 * B:3 * B], pos[3 * B:]
            overflow = ovf.reshape(4, B).any(axis=0)
        else:
            p1, o1 = run(np.concatenate([r1, reverse_complement(r1)]))
            p2, o2 = run(np.concatenate([reverse_complement(r2), r2]))
            p1f, p1r, p2r, p2f = p1[:B], p1[B:], p2[:B], p2[B:]
            overflow = o1[:B] | o1[B:] | o2[:B] | o2[B:]
        rows = [torch.from_numpy(p.astype(np.int64)).to(self.device) for p in (p1f, p2r, p1r, p2f)]
        pairs, strand, counts = pair_join(*rows, L1, L2, self.imin, self.imax, self.max_pairs)
        return (pairs.cpu().numpy().astype(np.uint32), strand.cpu().numpy(),
                counts.cpu().numpy().astype(np.uint32), overflow)
