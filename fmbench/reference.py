"""The plain reference: SA intervals, text positions and Hamming <= 1 counts
of reads, worked out from the text alone.

It shares nothing with the FM-index. The rows of the suffix array of
text + '$' ('$' below every base) are the text's n + 1 suffixes in order. A
read's interval [L, R) is the rows whose suffix starts with the read: L counts
the suffixes below it, R - L the suffixes it prefixes. Both come from the
suffixes' first ``PREFIX`` bases, packed base 5 (0 past the end of the text,
so a suffix that ends sorts below its extensions) and sorted once: a binary
search gives the suffixes whose prefix is below the read's, and the few whose
prefix equals it are compared with the rest of the read base by base. The
positions of an interval's first rows are those equal suffixes in suffix
order. A read's occurrences within Hamming distance 1 are found by the
pigeonhole rule (one half of the read matches exactly, so the first
``PREFIX`` bases of that half do) and verified by counting mismatches.

Plain PyTorch on any device: run once the window has closed and the program's
state is freed, in chunks of ``CHUNK`` reads.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

#: bases of a suffix's sort key: 5^27 < 2^63
PREFIX = 27
#: zero digits past the end of the text, for windows that run past it
PAD = 1024
#: reads a chunk
CHUNK = 1 << 20
#: a position past an interval's count
FULL = 0xFFFFFFFF


def _members(order: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor):
    """(read index, text position) of every sorted suffix in [lo, hi) of each read."""
    g = hi - lo
    rid = torch.repeat_interleave(torch.arange(g.shape[0], device=g.device), g)
    first = torch.cumsum(g, 0) - g
    idx = torch.arange(rid.shape[0], device=g.device) - first[rid] + lo[rid]
    return rid, order[idx]


class SuffixOrder:
    """The text's suffixes sorted by their first ``PREFIX`` bases.

    text: uint8 [n] codes 0..3 on the device the reference runs on;
    text_host: the same text as numpy, for the rare reads with more than one
    occurrence, whose positions are put in suffix order on the host."""

    def __init__(self, text: torch.Tensor, text_host: np.ndarray):
        n = text.shape[0]
        self.n, self.text_host = n, text_host
        self.digits = torch.zeros(n + PAD, dtype=torch.uint8, device=text.device)
        self.digits[:n] = text
        self.digits[:n] += 1
        code = torch.zeros(n + 1, dtype=torch.int64, device=text.device)
        for j in range(PREFIX):
            code.mul_(5).add_(self.digits[j:j + n + 1])
        self.codes, self.order = torch.sort(code)
        del code

    @property
    def device(self) -> torch.device:
        return self.digits.device

    def _range(self, digits: torch.Tensor):
        """Sorted rows [lo, hi) whose suffix's key equals the key of
        ``digits`` (uint8 [B, PREFIX], bases + 1)."""
        key = torch.zeros(digits.shape[0], dtype=torch.int64, device=digits.device)
        for j in range(PREFIX):
            key = key * 5 + digits[:, j]
        return (torch.searchsorted(self.codes, key, side="left"),
                torch.searchsorted(self.codes, key, side="right"))

    def _rank(self, reads: torch.Tensor):
        """(L, R, read index and position of every suffix the read prefixes)."""
        B, L = reads.shape
        if L <= PREFIX or L > PAD:
            raise ValueError(f"reads of {L} bases: the reference takes {PREFIX + 1} to {PAD}")
        rd = reads.to(self.device) + 1
        lo, hi = self._range(rd[:, :PREFIX])
        rid, pos = _members(self.order, lo, hi)
        win = self.digits.unfold(0, L - PREFIX, 1)[pos + PREFIX]
        want = rd[rid, PREFIX:]
        diff = win != want
        differs = diff.any(dim=1)
        first = diff.to(torch.uint8).argmax(dim=1, keepdim=True)
        below = differs & (win.gather(1, first)[:, 0] < want.gather(1, first)[:, 0])
        less = torch.zeros(B, dtype=torch.int64, device=self.device).index_add_(0, rid, below.to(torch.int64))
        equal = torch.zeros(B, dtype=torch.int64, device=self.device).index_add_(0, rid, (~differs).to(torch.int64))
        left = lo + less
        return left, left + equal, rid[~differs], pos[~differs]

    def intervals(self, reads: torch.Tensor) -> torch.Tensor:
        """int64 [B, 2]: each read's SA interval (L, R) over text + '$'."""
        out = [torch.stack(self._rank(c)[:2], dim=1) for c in reads.split(CHUNK)]
        return torch.cat(out) if out else torch.zeros((0, 2), dtype=torch.int64, device=self.device)

    def _suffix_cmp(self, a: int, b: int) -> int:
        t, step, off = self.text_host, 4096, 0
        while True:
            x, y = t[a + off:a + off + step], t[b + off:b + off + step]
            m = min(len(x), len(y))
            d = np.flatnonzero(x[:m] != y[:m])
            if d.size:
                return -1 if x[d[0]] < y[d[0]] else 1
            if len(x) < step or len(y) < step:
                return (len(x) > len(y)) - (len(x) < len(y))
            off += step

    def locate(self, reads: torch.Tensor, max_hits: int):
        """(int64 [B, 2] intervals, int64 [B, max_hits] text positions of
        each interval's first max_hits rows in row order, FULL past its
        count)."""
        ivs, poss = [], []
        for c in reads.split(CHUNK):
            left, right, rid, pos = self._rank(c)
            out = torch.full((c.shape[0], max_hits), FULL, dtype=torch.int64, device=self.device)
            count = right - left
            one = count[rid] == 1
            out[rid[one], 0] = pos[one]
            many = ~one
            if many.any():
                r, p = rid[many].cpu().numpy(), pos[many].cpu().numpy()
                cut = np.flatnonzero(np.diff(r)) + 1
                for rr, pp in zip(np.split(r, cut), np.split(p, cut)):
                    ranked = sorted(pp.tolist(), key=functools.cmp_to_key(self._suffix_cmp))[:max_hits]
                    out[int(rr[0]), :len(ranked)] = torch.tensor(ranked, dtype=torch.int64)
            ivs.append(torch.stack([left, right], dim=1))
            poss.append(out)
        return torch.cat(ivs), torch.cat(poss)

    def counts(self, reads: torch.Tensor) -> torch.Tensor:
        """int64 [B]: each read's exact occurrences."""
        iv = self.intervals(reads)
        return iv[:, 1] - iv[:, 0]

    def _hamming1(self, reads: torch.Tensor) -> torch.Tensor:
        B, L = reads.shape
        h = L // 2
        if h < PREFIX or L - h < PREFIX or L > PAD:
            raise ValueError(f"reads of {L} bases: Hamming counts take {2 * PREFIX} to {PAD}")
        rd = reads.to(self.device) + 1
        rids, starts = [], []
        for o in (0, h):
            rid, pos = _members(self.order, *self._range(rd[:, o:o + PREFIX]))
            start = pos - o
            ok = (start >= 0) & (start <= self.n - L)
            rids.append(rid[ok])
            starts.append(start[ok])
        key = torch.unique(torch.cat(rids) * (self.n + 1) + torch.cat(starts))
        rid, start = key // (self.n + 1), key % (self.n + 1)
        mism = (self.digits.unfold(0, L, 1)[start] != rd[rid]).sum(dim=1)
        return torch.zeros(B, dtype=torch.int64, device=self.device).index_add_(0, rid, (mism <= 1).to(torch.int64))

    def counts_hamming1(self, reads: torch.Tensor) -> torch.Tensor:
        """int64 [B]: each read's occurrences within Hamming distance 1
        (text windows of its length that differ from it in at most one
        base)."""
        out = [self._hamming1(c) for c in reads.split(CHUNK)]
        return torch.cat(out) if out else torch.zeros(0, dtype=torch.int64, device=self.device)
