"""SAM v1.6 records of single-end and paired-end placements: exact, Hamming
and edit-distance sites on both strands.

Counterpart of tpufm/io/sam.py (``sam_header`` :108, ``sam_single_records``
:131, ``sam_edit_records`` :298, ``sam_paired_records`` :370, ``_mapq``,
``_qual2``, ``_concat_offsets``, ``_emit``), byte for byte. Exact and
Hamming sites are ``<L>M`` CIGARs with NM:i the site's distance;
edit-distance sites are re-aligned on the host (``host/align.py``) for
M/I/D CIGARs.

- POS is 1-based; RNAME and POS come from the record map
  (``host/contigs.py``); a hit that crosses a record's end is dropped.
- SEQ is in the forward reference's orientation: the read's reverse
  complement on a minus-strand record (FLAG 0x10), whose QUAL is reversed
  too. QUAL is '*' without qualities (FASTA input).
- One primary record a mapped read, the lowest-NM site (ties: forward
  strand first, then position order); the other sites are secondary
  (0x100). MAPQ is 60 when the lowest NM is unique among the reported
  sites, else 0. A read with no site gets one unmapped record (FLAG 4).
- Paired FR records: 0x1|0x2, 0x40/0x80, 0x10/0x20, RNEXT '=', PNEXT and
  a signed TLEN (under edits the right mate's aligned span); a pair with
  no proper placement gets the unmapped pair (FLAG 77 / 141).

``sam_single_records`` formats its records either in the native emitter
(csrc/samemit.cpp, ``emitter="native"``, the default; built with the host
C++ compiler at first use, and a failed build raises) or in the Python
loop (``emitter="python"``, its plain version). The one case in which the
native emitter hands over to the loop is a read with more than 512 sites
(2 * max_hits > 512), past the emitter's fixed site buffer.
"""

from __future__ import annotations

import ctypes

import numpy as np

from tpufm_torch.host.align import edit_alignments
from tpufm_torch.host.seqio import decode_bases, reverse_complement

_SENT = np.uint32(0xFFFFFFFF)
#: sites of one read that the native emitter's buffer holds (csrc/samemit.cpp)
NATIVE_MAX_SITES = 512
#: sites re-aligned at a time: the traceback matrix is [chunk, L, L+E] int8
_REALIGN_CHUNK = 1 << 16

_emit_lib = None


def emitter_library() -> ctypes.CDLL:
    """The native record emitter (csrc/samemit.cpp), built on first use."""
    global _emit_lib
    if _emit_lib is None:
        from tpufm_torch.kernels import host_library

        lib = host_library("samemit.cpp", "libsamemit")
        _I, _P = ctypes.c_int64, ctypes.c_void_p
        # B, H, Lmax; Ls, fwd, rc, names, names_off, quals, quals_off, cnames,
        # cnames_off, then ok, nm, idx, p1 of each strand, and out; out_cap; ends
        lib.tpufm_sam_emit_single.argtypes = [_I, _I, _I] + [_P] * 18 + [_I, _P]
        lib.tpufm_sam_emit_single.restype = _I
        _emit_lib = lib
    return _emit_lib


def _concat_offsets(strs):
    """list[str] -> (utf-8 bytes joined, int64 [n+1] offsets)."""
    bufs = [s.encode() for s in strs]
    off = np.zeros(len(bufs) + 1, np.int64)
    np.cumsum([len(b) for b in bufs], out=off[1:])
    return b"".join(bufs), off


def _qual2(quals, i):
    """(forward, reversed) QUAL of read i: '*' for both without qualities
    or with malformed ones."""
    q = None if quals is None else quals[i]
    return (q, q[::-1]) if q else ("*", "*")


def _mapq(nms) -> int:
    """60 when the lowest NM is unique among the sites, else 0 (0 too when
    there is no site)."""
    if not nms:
        return 0
    best = min(nms)
    return 60 if sum(1 for v in nms if v == best) == 1 else 0


def sam_header(cmap, extra_pg: str = "") -> str:
    """@HD, one @SQ a record of the map, and @PG (with CL: ``extra_pg``)."""
    lines = ["@HD\tVN:1.6\tSO:unknown"]
    ends = np.append(cmap.starts[1:], cmap.total)
    for name, start, end in zip(cmap.names, cmap.starts, ends):
        lines.append(f"@SQ\tSN:{name}\tLN:{int(end - start)}")
    pg = "@PG\tID:tpufm\tPN:tpufm"
    if extra_pg:
        pg += f"\tCL:{extra_pg}"
    lines.append(pg)
    return "\n".join(lines) + "\n"


def _emit(blocks, return_blocks: bool):
    """The record lines of every read's block joined into text, or with
    ``return_blocks`` the blocks themselves (a caller that grouped reads
    re-emits them in input order)."""
    if return_blocks:
        return blocks
    return "\n".join(line for b in blocks for line in b) + "\n"


def sam_single_records(names, reads, pos_fwd, pos_rc, cmap, codes=None, lengths=None,
                       return_blocks: bool = False, quals=None, emitter: str = "native"):
    """One SAM block a read: its sites over both strands, or one unmapped
    record.

    names: QNAMEs (a list or ``PackedStrs``). reads: uint8 [B, L] as
    sequenced. pos_fwd / pos_rc: uint32 [B, H] absolute positions of the
    read and of its reverse complement, 0xFFFFFFFF-padded. codes: the 2-bit
    reference, for NM:i as each site's Hamming distance; None for exact
    sites (NM:i:0). lengths: each read's length in a right-aligned
    0xFF-padded batch (the variable-length search's shape). quals: Phred+33
    strings as sequenced (a list or ``PackedStrs``), or None. emitter:
    "native" (csrc/samemit.cpp) or "python" (the loop below); both give
    the same bytes."""
    if emitter not in ("native", "python"):
        raise ValueError(f"unknown emitter {emitter!r} (native or python)")
    B, Lmax = reads.shape
    Ls = np.full(B, Lmax, dtype=np.int64) if lengths is None else np.asarray(lengths, dtype=np.int64)
    # every array pass happens here; the per-read loop sees lists and strings
    idx_f, off_f, sp_f = cmap.resolve(pos_fwd, query_len=Ls[:, None])
    idx_r, off_r, sp_r = cmap.resolve(pos_rc, query_len=Ls[:, None])
    # one decode for all forward reads and one for all reverse complements;
    # pad bytes decode to 'T' and are sliced away (reads right-aligned, their
    # reverse complements left-aligned)
    fwd_bytes = decode_bases(np.minimum(reads, 3).reshape(-1))
    rcb = reads[:, ::-1]
    rcb = np.where(rcb <= 3, 3 - rcb, 0).astype(np.uint8)
    rc_bytes = decode_bases(rcb.reshape(-1))
    ok_f = (pos_fwd != _SENT) & (idx_f >= 0) & ~sp_f
    ok_r = (pos_rc != _SENT) & (idx_r >= 0) & ~sp_r
    H = pos_fwd.shape[1]
    nm_f = np.zeros((B, H), np.int64)
    nm_r = np.zeros((B, H), np.int64)
    if codes is not None:
        n = codes.shape[0]
        for L in np.unique(Ls):
            L = int(L)
            rowsel = Ls == L
            win = np.arange(L)
            for ok, pos, nm, mat in ((ok_f, pos_fwd, nm_f, reads[:, Lmax - L:]),
                                     (ok_r, pos_rc, nm_r, rcb[:, :L])):
                si, sj = np.nonzero(ok & rowsel[:, None])
                if not si.size:
                    continue
                w = pos[si, sj].astype(np.int64)[:, None] + win
                nm[si, sj] = (np.where(w < n, codes[np.minimum(w, n - 1)], 255) != mat[si]).sum(1)
    if emitter == "native" and 2 * H <= NATIVE_MAX_SITES:
        return _native_records(names, quals, cmap, B, H, Lmax, Ls, fwd_bytes, rc_bytes,
                               (ok_f, nm_f, idx_f, off_f), (ok_r, nm_r, idx_r, off_r), return_blocks)
    fwd_ascii = fwd_bytes.decode()
    rc_ascii = rc_bytes.decode()
    ok_f, ok_r = ok_f.tolist(), ok_r.tolist()
    nm_f, nm_r = nm_f.tolist(), nm_r.tolist()
    idx_f, idx_r = idx_f.tolist(), idx_r.tolist()
    p1_f, p1_r = (off_f + 1).tolist(), (off_r + 1).tolist()
    cnames = cmap.names
    blocks = []
    for i, name in enumerate(names):
        out = []
        blocks.append(out)
        L = int(Ls[i])
        base = i * Lmax
        seq_f = fwd_ascii[base + Lmax - L:base + Lmax]
        seq_r = rc_ascii[base:base + L]
        sites = []  # (nm, order, flag, rname, pos1, seq)
        for ok, nm, idx, p1, flag, seq in ((ok_f[i], nm_f[i], idx_f[i], p1_f[i], 0, seq_f),
                                           (ok_r[i], nm_r[i], idx_r[i], p1_r[i], 16, seq_r)):
            for j in range(H):
                if ok[j]:
                    sites.append((nm[j], len(sites), flag, cnames[idx[j]], p1[j], seq))
        sites.sort(key=lambda s: (s[0], s[1]))
        mapq = _mapq([s[0] for s in sites])
        qf, qr = _qual2(quals, i)
        for emitted, (nm, _, flag, rname, pos1, seq) in enumerate(sites):
            f = flag | (0x100 if emitted else 0)
            out.append(f"{name}\t{f}\t{rname}\t{pos1}\t{mapq}\t{L}M\t*\t0\t0\t"
                       f"{seq}\t{qr if flag & 0x10 else qf}\tNM:i:{nm}")
        if not sites:
            out.append(f"{name}\t4\t*\t0\t0\t*\t*\t0\t0\t{seq_f}\t{qf}")
    return _emit(blocks, return_blocks)


def _native_records(names, quals, cmap, B, H, Lmax, Ls, fwd_bytes, rc_bytes, fwd, rc, return_blocks):
    """``sam_single_records``' records formatted by csrc/samemit.cpp from the
    per-site arrays (ok, nm, record, offset) of each strand."""
    lib = emitter_library()
    names_buf, names_off = (names.buf, names.off) if hasattr(names, "off") else _concat_offsets(names)
    if quals is None:
        quals_buf, quals_off = b"", None
    elif hasattr(quals, "off"):
        quals_buf, quals_off = quals.buf, quals.off
    else:
        quals_buf, quals_off = _concat_offsets([q or "" for q in quals])
    cnames_buf, cnames_off = _concat_offsets(list(cmap.names))
    counts = fwd[0].sum(axis=1) + rc[0].sum(axis=1)
    max_cname = int(np.diff(cnames_off).max()) if len(cmap.names) else 0
    qual_lens = np.diff(quals_off) if quals_off is not None else 0
    # a record is at most its name, record name, SEQ, QUAL and 128 bytes of
    # fields; a read writes max(sites, 1) records
    cap = int((np.maximum(counts, 1) * (np.diff(names_off) + max_cname + Ls + qual_lens + 128)).sum()) + 1
    out_buf = np.empty(cap, np.uint8)
    ends = np.empty(max(B, 1), np.int64)
    # every buffer the call reads or writes, held here until it returns
    arrays = [np.ascontiguousarray(a, dtype) for a, dtype in (
        (Ls, np.int64), (names_off, np.int64), (cnames_off, np.int64),
        *((a, t) for ok, nm, idx, off in (fwd, rc)
          for a, t in ((ok, np.int8), (nm, np.int64), (idx, np.int32), (off + 1, np.int64))))]
    quals_arr = None if quals_off is None else np.ascontiguousarray(quals_off, np.int64)
    ls, n_off, c_off, *strands = (a.ctypes.data for a in arrays)
    nwritten = lib.tpufm_sam_emit_single(
        B, H, Lmax, ls, fwd_bytes, rc_bytes, names_buf, n_off, quals_buf,
        None if quals_arr is None else quals_arr.ctypes.data, cnames_buf, c_off, *strands,
        out_buf.ctypes.data, cap, ends.ctypes.data)
    if nwritten < 0:
        raise RuntimeError(f"samemit: the records of {B} reads overflow their {cap}-byte buffer")
    raw = out_buf[:nwritten].tobytes()
    if not return_blocks:
        return raw.decode()
    blocks, prev = [], 0
    for e in ends[:B].tolist():
        blocks.append(raw[prev:e].decode().split("\n")[:-1])
        prev = e
    return blocks


def _realign(codes, mats, starts, edits: int):
    """``edit_alignments`` in chunks of ``_REALIGN_CHUNK`` sites: (cigars,
    nm, ref_span)."""
    cigars, nms, spans = [], [], []
    for lo in range(0, len(starts), _REALIGN_CHUNK):
        c, n, s = edit_alignments(codes, mats[lo:lo + _REALIGN_CHUNK], starts[lo:lo + _REALIGN_CHUNK], edits)
        cigars.extend(c)
        nms.append(n)
        spans.append(s)
    return cigars, np.concatenate(nms), np.concatenate(spans)


def sam_edit_records(names, reads, pos_fwd, pos_rc, cmap, codes, edits: int,
                     return_blocks: bool = False, quals=None):
    """Edit-distance SAM blocks: every reported site re-aligned on the host
    (``edit_alignments``) for its M/I/D CIGAR and NM:i; primary the lowest
    NM. A site is kept where its alignment's own reference span fits its
    record."""
    rcs = reverse_complement(reads)
    sites = []  # (read i, flag, absolute position)
    for i in range(len(names)):
        sites.extend((i, 0, p) for p in pos_fwd[i].tolist() if p != _SENT)
        sites.extend((i, 16, p) for p in pos_rc[i].tolist() if p != _SENT)
    per_read = {}
    if sites:
        mats = np.stack([(reads if f == 0 else rcs)[i] for i, f, _ in sites])
        pos_arr = np.asarray([p for _, _, p in sites], np.int64)
        cigars, nm, ref_span = _realign(codes, mats, pos_arr, edits)
        idx, off, _ = cmap.resolve(pos_arr.astype(np.uint32))
        ends = np.append(cmap.starts[1:], cmap.total)
        clen = ends[np.maximum(idx, 0)] - cmap.starts[np.maximum(idx, 0)]
        ok = (idx >= 0) & (off + ref_span <= clen)
        for j, (i, flag, _) in enumerate(sites):
            if ok[j]:
                rows = per_read.setdefault(i, [])
                rows.append((int(nm[j]), len(rows), flag, cmap.names[idx[j]], int(off[j]) + 1, cigars[j]))
    blocks = []
    for i, name in enumerate(names):
        out = []
        blocks.append(out)
        rows = sorted(per_read.get(i, []))
        seq_f = decode_bases(reads[i]).decode()
        seq_r = decode_bases(rcs[i]).decode()
        mapq = _mapq([r[0] for r in rows])
        qf, qr = _qual2(quals, i)
        for emitted, (nm_j, _, flag, rname, pos1, cigar) in enumerate(rows):
            f = flag | (0x100 if emitted else 0)
            minus = flag & 0x10
            out.append(f"{name}\t{f}\t{rname}\t{pos1}\t{mapq}\t{cigar}\t*\t0\t0\t"
                       f"{seq_r if minus else seq_f}\t{qr if minus else qf}\tNM:i:{nm_j}")
        if not rows:
            out.append(f"{name}\t4\t*\t0\t0\t*\t*\t0\t0\t{seq_f}\t{qf}")
    return _emit(blocks, return_blocks)


def sam_paired_records(names, r1, r2, pairs, strand, cmap, codes=None, edits: int = 0,
                       return_blocks: bool = False, quals1=None, quals2=None):
    """Two SAM records a read pair: the primary proper pair (lowest NM of
    both mates; ties in the engine's order), the other pairs as secondary
    record pairs, or the unmapped pair.

    pairs / strand: ``PairedEndEngine.pair``'s, pairs[i, j] = (leftmost
    mate start, rightmost mate start), strand 0 where R1 is the plus
    (leftmost) mate. codes: the 2-bit reference; with edits == 0 NM:i is
    each mate's Hamming distance, with edits > 0 both mates are
    re-aligned (M/I/D CIGARs; span checks and TLEN take the alignments'
    reference spans); None for exact pairs (NM:i:0)."""
    blocks = []
    B, P = pairs.shape[:2]
    L1, L2 = r1.shape[1], r2.shape[1]
    r1r = reverse_complement(r1)
    r2r = reverse_complement(r2)
    idx_l, off_l, _ = cmap.resolve(pairs[..., 0])
    idx_r, off_r, _ = cmap.resolve(pairs[..., 1])
    cends = np.append(cmap.starts[1:], cmap.total)
    clen_l = (cends - cmap.starts)[np.maximum(idx_l, 0)]
    clen_r = (cends - cmap.starts)[np.maximum(idx_r, 0)]
    valid = (pairs[..., 0] != _SENT) & (idx_l >= 0) & (idx_l == idx_r)
    vi, vj = np.nonzero(valid)
    len_left = np.where(strand == 0, L1, L2)
    len_right = np.where(strand == 0, L2, L1)
    span_l = len_left.astype(np.int64)
    span_r = len_right.astype(np.int64)
    nm_l = np.zeros((B, P), np.int64)
    nm_r = np.zeros((B, P), np.int64)
    cig_l = np.empty((B, P), object)
    cig_r = np.empty((B, P), object)
    # the accepted pair sites by strand, so that the two mates (which may
    # differ in length) never share a matrix: strand 0 has R1 forward on the
    # left and rc(R2) on the right, strand 1 R2 forward on the left and rc(R1)
    parts = []
    if codes is not None and len(vi):
        plus = strand[vi, vj] == 0
        parts = [(plus, r1, r2r), (~plus, r2, r1r)]
    if edits:
        span_l = np.broadcast_to(span_l, (B, P)).copy()
        span_r = np.broadcast_to(span_r, (B, P)).copy()
        for sel, left_rows, right_rows in parts:
            si, sj = vi[sel], vj[sel]
            if not len(si):
                continue
            for rows, col, nm_a, sp_a, cg_a in ((left_rows, 0, nm_l, span_l, cig_l),
                                                (right_rows, 1, nm_r, span_r, cig_r)):
                cigs, nms, spans = _realign(codes, rows[si], pairs[si, sj, col].astype(np.int64), edits)
                nm_a[si, sj] = nms
                sp_a[si, sj] = spans
                for t, c in enumerate(cigs):
                    cg_a[si[t], sj[t]] = c
    elif parts:
        n = codes.shape[0]

        def ham(mat, starts):
            w = starts[:, None] + np.arange(mat.shape[1])
            return (np.where(w < n, codes[np.minimum(w, n - 1)], 255) != mat).sum(1)

        for sel, left_rows, right_rows in parts:
            si, sj = vi[sel], vj[sel]
            if not len(si):
                continue
            nm_l[si, sj] = ham(left_rows[si], pairs[si, sj, 0].astype(np.int64))
            nm_r[si, sj] = ham(right_rows[si], pairs[si, sj, 1].astype(np.int64))
    sp_l = off_l + span_l > clen_l
    sp_r = off_r + span_r > clen_r
    for i, name in enumerate(names):
        out = []
        blocks.append(out)
        seq1f = decode_bases(r1[i]).decode()
        seq1r = decode_bases(r1r[i]).decode()
        seq2f = decode_bases(r2[i]).decode()
        seq2r = decode_bases(r2r[i]).decode()
        q1f, q1r = _qual2(quals1, i)
        q2f, q2r = _qual2(quals2, i)
        rows = sorted((int(nm_l[i, j] + nm_r[i, j]), j) for j in range(P)
                      if valid[i, j] and not sp_l[i, j] and not sp_r[i, j])
        mapq = _mapq([nm for nm, _ in rows])
        for emitted, (_, j) in enumerate(rows):
            rname = cmap.names[idx_l[i, j]]
            lpos1, rpos1 = int(off_l[i, j]) + 1, int(off_r[i, j]) + 1
            frag = int(off_r[i, j]) + int(span_r[i, j]) - int(off_l[i, j])
            c_l = cig_l[i, j] or f"{int(len_left[i, j])}M"
            c_r = cig_r[i, j] or f"{int(len_right[i, j])}M"
            if strand[i, j] == 0:  # R1 forward on the left, rc(R2) on the right
                p1, f1, s1, c1, n1, q1 = lpos1, 0x63, seq1f, c_l, nm_l[i, j], q1f
                p2, f2, s2, c2, n2, q2 = rpos1, 0x93, seq2r, c_r, nm_r[i, j], q2r
            else:  # R2 forward on the left, rc(R1) on the right
                p1, f1, s1, c1, n1, q1 = rpos1, 0x53, seq1r, c_r, nm_r[i, j], q1r
                p2, f2, s2, c2, n2, q2 = lpos1, 0xA3, seq2f, c_l, nm_l[i, j], q2f
            sec = 0x100 if emitted else 0
            t1 = frag if p1 <= p2 else -frag
            out.append(f"{name}\t{f1 | sec}\t{rname}\t{p1}\t{mapq}\t{c1}\t=\t"
                       f"{p2}\t{t1}\t{s1}\t{q1}\tNM:i:{int(n1)}")
            out.append(f"{name}\t{f2 | sec}\t{rname}\t{p2}\t{mapq}\t{c2}\t=\t"
                       f"{p1}\t{-t1}\t{s2}\t{q2}\tNM:i:{int(n2)}")
        if not rows:
            out.append(f"{name}\t77\t*\t0\t0\t*\t*\t0\t0\t{seq1f}\t{q1f}")
            out.append(f"{name}\t141\t*\t0\t0\t*\t*\t0\t0\t{seq2f}\t{q2f}")
    return _emit(blocks, return_blocks)
