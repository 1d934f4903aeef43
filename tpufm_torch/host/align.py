"""CIGARs of edit-distance sites, re-aligned on the host.

Counterpart of tpufm/utils/align.py (``edit_alignments`` :28). The edit
engine reports start sites and distances but no alignment path (the Myers
scan never holds the DP matrix), and SAM needs the path. So each reported
site (max_hits a read, not the candidate grid) is re-aligned here: a
start-anchored, free-end Levenshtein DP over numpy lanes, one row a read
character, with an int8 traceback matrix.

CIGARs are relative to the read as stored in SEQ: M consumes read and
reference (match or mismatch), I the read only, D the reference only.
Alignments are anchored at the start and have no clips; a path whose
optimum begins with deletions keeps those leading D ops, so the CIGAR
always covers the whole reference span. NM is substitutions plus I and D
lengths. Ties break toward M, then I, then D.
"""

from __future__ import annotations

import numpy as np

#: traceback codes: M (diagonal), I (up), D (left)
_M, _I, _D = 0, 1, 2


def edit_alignments(codes, reads, starts, edits: int):
    """Best start-anchored, free-end alignments of ``reads[i]`` against
    ``codes[starts[i]:]``.

    codes: uint8 [n] 2-bit reference. reads: uint8 [N, L] in the forward
    reference's orientation (the reverse complement for a minus-strand
    site). starts: [N] absolute starts. edits: the engine's E; the free end
    lies within starts[i] + L + E.

    Returns (cigars list[str], nm int32 [N], ref_span int32 [N]: the
    reference bases each alignment consumes). The end is the leftmost
    column of least distance."""
    codes = np.asarray(codes, np.uint8)
    reads = np.asarray(reads, np.uint8)
    starts = np.asarray(starts, np.int64)
    N, L = reads.shape
    TL = L + edits
    if N == 0:
        return [], np.zeros(0, np.int32), np.zeros(0, np.int32)
    # the window; characters past either end of the text never match
    idx = starts[:, None] + np.arange(TL)[None, :]
    inside = (idx >= 0) & (idx < codes.shape[0])
    t = np.where(inside, codes[np.clip(idx, 0, codes.shape[0] - 1)], 255)

    ar = np.arange(TL + 1, dtype=np.int32)
    prev = np.broadcast_to(ar, (N, TL + 1)).copy()  # row 0: D[0][c] = c
    ptr = np.empty((N, L, TL), np.int8)
    for r in range(1, L + 1):
        diag = prev[:, :-1] + (reads[:, r - 1, None] != t).astype(np.int32)
        up = prev[:, 1:] + 1
        # cur[c] = min(min(diag, up)[c-1], cur[c-1] + 1) with cur[0] = r,
        # by the running minimum of (x - c) + c
        c0 = np.concatenate([np.full((N, 1), r, np.int32), np.minimum(diag, up)], axis=1)
        cur = np.minimum.accumulate(c0 - ar, axis=1) + ar
        body = cur[:, 1:]
        p = np.where(body == up, np.int8(_I), np.int8(_D))
        ptr[:, r - 1] = np.where(body == diag, np.int8(_M), p)
        prev = cur

    end_c = np.argmin(prev, axis=1).astype(np.int32)
    nm = prev[np.arange(N), end_c].astype(np.int32)
    cigars = []
    for i in range(N):
        ops = []
        r, c = L, int(end_c[i])
        while r > 0:
            if c == 0:  # only insertions remain
                ops.append(_I)
                r -= 1
                continue
            op = int(ptr[i, r - 1, c - 1])
            ops.append(op)
            if op == _M:
                r -= 1
                c -= 1
            elif op == _I:
                r -= 1
            else:
                c -= 1
        # leading deletions: the path enters the read at reference column c
        ops.extend([_D] * c)
        ops.reverse()
        runs = []
        for op in ops:
            sym = "MID"[op]
            if runs and runs[-1][1] == sym:
                runs[-1][0] += 1
            else:
                runs.append([1, sym])
        cigars.append("".join(f"{n}{s}" for n, s in runs))
    return cigars, nm, end_c
