"""Coordinate sort, BAI index, indexed region query and the samtools-style
summaries (flagstat, idxstats, depth, stats, bedcov, markdup, fastq) over
SAM/BAM: what the CLI's ``sort``, ``view``, ``merge`` and the other
host-only tools run. None of it touches the card.

Counterpart of tpufm/io/bam_index.py, function for function and in its
order of operations, so that the same input gives the same bytes: the sort
key and its stability on ties (``sort_sam_text`` :48), the fixed
``BGZF_STEP`` members that make a virtual offset ``(member start << 16) |
(u % BGZF_STEP)`` (``_voffset`` :87), the 16 KiB linear index (``build_bai``
:104), markdup's choice among equal QUAL sums (input order, :731) and
``sam_stats``' number formatting (:546).

Formats per SAM spec v1.6: section 5.2 (UCSC binning: reg2bin/reg2bins),
5.3 (BAI layout: per-ref bin R-tree of virtual-offset chunks + 16 KiB
linear index). Virtual offsets pack (compressed member start << 16 |
offset inside the inflated member); the bgzf writer (host/bam.py) emits
fixed BGZF_STEP-byte uncompressed members, so uncompressed offset u maps
to member u // BGZF_STEP at in-member offset u % BGZF_STEP.
"""

from __future__ import annotations

import re
import struct

import numpy as np

from tpufm_torch.host.bam import (
    BGZF_STEP,
    _BGZF_EOF,
    _CIGAR_OPS,
    _NIB_PAIR,
    _QUAL_TBL_INV,
    _decode_tags,
    bgzf_compress,
    bgzf_member_at,
    reg2bin,
    sam_to_bam,
)

_BAI_MAGIC = b"BAI\x01"
_LIN_SHIFT = 14  # 16 KiB linear-index windows (SAM spec v1.6 5.1.1)


def reg2bins(beg: int, end: int) -> list[int]:
    """All bins that MAY hold records overlapping [beg, end) — the query
    side of reg2bin (SAM spec v1.6 5.3 C example)."""
    end -= 1
    bins = [0]
    for shift, off in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(off + (beg >> shift), off + (end >> shift) + 1))
    return bins


def sort_sam_text(sam_text: str) -> str:
    """Coordinate-sort SAM text: records ordered by (@SQ rank, POS),
    unmapped (RNAME '*') last, ties stable; @HD gains SO:coordinate."""
    header, records = [], []
    sq_rank: dict[str, int] = {}
    for line in sam_text.split("\n"):
        if not line:
            continue
        if line.startswith("@"):
            if line.startswith("@SQ"):
                f = dict(kv.split(":", 1) for kv in line.split("\t")[1:])
                sq_rank[f["SN"]] = len(sq_rank)
            header.append(line)
        else:
            records.append(line)
    for i, line in enumerate(header):
        if line.startswith("@HD"):
            parts = [p for p in line.split("\t") if not p.startswith("SO:")]
            header[i] = "\t".join(parts) + "\tSO:coordinate"
            break
    else:
        header.insert(0, "@HD\tVN:1.6\tSO:coordinate")

    def key(line: str):
        f = line.split("\t", 4)
        if f[2] == "*":
            return (1, 0, 0)
        try:
            rank = sq_rank[f[2]]
        except KeyError:
            raise ValueError(
                f"RNAME {f[2]!r} is not declared in any @SQ header line"
            ) from None
        return (0, rank, int(f[3]))

    records.sort(key=key)
    return "\n".join(header + records) + "\n"


def _voffset(u: int, member_offsets: list[int]) -> int:
    """Uncompressed stream offset -> BAI virtual offset, exploiting the
    writer's fixed BGZF_STEP-byte members. `member_offsets` comes from
    bgzf_compress and carries a trailing sentinel (the EOF member's
    offset), so u == stream length lands on the EOF member at in-member
    offset 0 even when the length is an exact BGZF_STEP multiple —
    without the sentinel that case produced an inverted (end < start)
    chunk that dropped the final record from indexed queries."""
    i = u // BGZF_STEP
    if i >= len(member_offsets):
        raise ValueError(
            f"uncompressed offset {u} beyond the bgzf stream "
            f"({len(member_offsets) - 1} data members)"
        )
    return (member_offsets[i] << 16) | (u % BGZF_STEP)


def build_bai(record_meta, member_offsets, n_ref: int) -> bytes:
    """Serialize a BAI index (SAM spec v1.6 5.3) from sam_to_bam's
    record_meta [(ustart, uend, ref_id, pos0, ref_end)] and
    bgzf_compress's member_offsets. Records must already be in
    coordinate order (build after sort_sam_text; enforced here)."""
    bins: list[dict[int, list[list[int]]]] = [dict() for _ in range(n_ref)]
    linear: list[dict[int, int]] = [dict() for _ in range(n_ref)]
    prev = (-1, -1)
    for ustart, uend, ref_id, pos0, ref_end in record_meta:
        if ref_id < 0:
            continue
        if (ref_id, pos0) < prev:
            raise ValueError("build_bai needs coordinate-sorted records "
                             "(run sort_sam_text first)")
        prev = (ref_id, pos0)
        vs = _voffset(ustart, member_offsets)
        ve = _voffset(uend, member_offsets)
        b = reg2bin(pos0, ref_end)
        chunks = bins[ref_id].setdefault(b, [])
        if chunks and chunks[-1][1] == vs:
            chunks[-1][1] = ve  # merge back-to-back chunks
        else:
            chunks.append([vs, ve])
        lin = linear[ref_id]
        last_w = max(ref_end - 1, pos0) >> _LIN_SHIFT
        for w in range(pos0 >> _LIN_SHIFT, last_w + 1):
            if w not in lin or vs < lin[w]:
                lin[w] = vs
    out = [_BAI_MAGIC, struct.pack("<i", n_ref)]
    for r in range(n_ref):
        out.append(struct.pack("<i", len(bins[r])))
        for b in sorted(bins[r]):
            chunks = bins[r][b]
            out.append(struct.pack("<Ii", b, len(chunks)))
            for vs, ve in chunks:
                out.append(struct.pack("<QQ", vs, ve))
        n_intv = max(linear[r]) + 1 if linear[r] else 0
        out.append(struct.pack("<i", n_intv))
        ioff = 0
        for w in range(n_intv):
            # spec: windows with no earlier record inherit the previous
            # window's offset (0 before the first covered window)
            ioff = linear[r].get(w, ioff)
            out.append(struct.pack("<Q", ioff))
        # (htslib fills gaps with the last seen offset; 0 also validates)
    return b"".join(out)


def write_bam_indexed(path: str, sam_text: str) -> None:
    """Coordinate-sort `sam_text`, write `path` (bgzf BAM) and
    `path`.bai. One call = a sorted, indexed, query-ready BAM."""
    text = sort_sam_text(sam_text)
    meta: list = []
    raw = sam_to_bam(text, record_meta=meta)
    n_ref = struct.unpack_from(
        "<i", raw, 8 + struct.unpack_from("<i", raw, 4)[0]
    )[0]
    member_offsets: list[int] = []
    blob = bgzf_compress(raw, member_offsets)
    with open(path, "wb") as fp:
        fp.write(blob)
    with open(path + ".bai", "wb") as fp:
        fp.write(build_bai(meta, member_offsets, n_ref))


def load_bai(path: str):
    """-> (bins, linear): bins[ref][bin] = [(vbeg, vend), ...],
    linear[ref] = [ioffset per 16 KiB window]."""
    raw = open(path, "rb").read()
    if raw[:4] != _BAI_MAGIC:
        raise ValueError("bad BAI magic")
    (n_ref,) = struct.unpack_from("<i", raw, 4)
    off = 8
    bins, linear = [], []
    for _ in range(n_ref):
        (n_bin,) = struct.unpack_from("<i", raw, off)
        off += 4
        bd = {}
        for _ in range(n_bin):
            b, n_chunk = struct.unpack_from("<Ii", raw, off)
            off += 8
            bd[b] = [
                struct.unpack_from("<QQ", raw, off + 16 * c)
                for c in range(n_chunk)
            ]
            off += 16 * n_chunk
        (n_intv,) = struct.unpack_from("<i", raw, off)
        off += 4
        linear.append(
            list(struct.unpack_from(f"<{n_intv}Q", raw, off))
        )
        off += 8 * n_intv
        bins.append(bd)
    return bins, linear


class IndexedBam:
    """Random-access reader over a (sorted, indexed) BAM: inflates ONLY
    the bgzf members a query's chunk list touches."""

    def __init__(self, bam_path: str, bai_path: str | None = None):
        self.blob = open(bam_path, "rb").read()
        self.bins, self.linear = load_bai(bai_path or bam_path + ".bai")
        # inflate members until the whole header block (text + ref dir,
        # possibly spanning members for many-contig references) is in
        head, coff = bgzf_member_at(self.blob, 0)

        def need(n):
            nonlocal head, coff
            while len(head) < n:
                chunk, coff = bgzf_member_at(self.blob, coff)
                if not chunk:
                    raise ValueError("truncated BAM header")
                head += chunk
            return n

        need(12)
        if head[:4] != b"BAM\x01":
            raise ValueError("bad BAM magic")
        (l_text,) = struct.unpack_from("<i", head, 4)
        need(8 + l_text + 4)
        self.header_text = head[8 : 8 + l_text].decode()
        off = 8 + l_text
        (n_ref,) = struct.unpack_from("<i", head, off)
        off += 4
        self.ref_names = []
        self.ref_lengths = []
        for _ in range(n_ref):
            need(off + 4)
            (l_name,) = struct.unpack_from("<i", head, off)
            need(off + 8 + l_name)
            self.ref_names.append(
                head[off + 4 : off + 4 + l_name - 1].decode()
            )
            (ln,) = struct.unpack_from("<i", head, off + 4 + l_name)
            self.ref_lengths.append(ln)
            off += 8 + l_name
        self._members: dict[int, tuple[bytes, int]] = {}

    def _member(self, coff: int) -> tuple[bytes, int]:
        """(inflated member at compressed offset coff, next member's
        offset) — cached, so chunk walks inflate each member once."""
        got = self._members.get(coff)
        if got is None:
            got = bgzf_member_at(self.blob, coff)
            self._members[coff] = got
        return got

    def _read_at(self, voff: int, n: int) -> bytes:
        """n uncompressed bytes starting at virtual offset voff,
        crossing members as needed (fixed BGZF_STEP stride)."""
        coff, within = voff >> 16, voff & 0xFFFF
        out = b""
        while len(out) < n:
            chunk, nxt = self._member(coff)
            out += chunk[within : within + n - len(out)]
            if len(out) < n:
                coff, within = nxt, 0
                if self.blob[coff : coff + len(_BGZF_EOF)] == _BGZF_EOF:
                    raise ValueError("truncated BAM record")
        return out

    def _record_at(self, voff: int):
        """-> (raw record incl. length prefix, next record's voffset)."""
        head = self._read_at(voff, 4)
        (block,) = struct.unpack("<I", head)
        rec = self._read_at(voff, 4 + block)
        coff, within = voff >> 16, (voff & 0xFFFF) + 4 + block
        while within >= BGZF_STEP:
            coff = self._member(coff)[1]
            within -= BGZF_STEP
        return rec, (coff << 16) | within

    def query(self, contig: str, beg: int, end: int):
        """All records overlapping [beg, end) (0-based, half-open) of
        `contig`, as raw BAM record blocks (decode with
        decode_record). Uses bins + linear index, then a
        final exact overlap filter."""
        ref_id = self.ref_names.index(contig)
        bd = self.bins[ref_id]
        chunks = []
        for b in reg2bins(beg, end):
            chunks.extend(bd.get(b, ()))
        # linear-index pruning: no record overlapping [beg, ...) starts
        # before loff, so chunks wholly before it are skipped and chunk
        # starts clamp up to it (loff is a record-aligned voffset)
        lin = self.linear[ref_id]
        w = beg >> _LIN_SHIFT
        loff = lin[w] if w < len(lin) else (lin[-1] if lin else 0)
        chunks = sorted(c for c in chunks if c[1] > loff)
        # keyed by voffset, NOT content: a record reachable through
        # multiple chunks dedups, but byte-identical DISTINCT records
        # (legitimate, e.g. duplicates in a merged pre-markdup BAM) must
        # all be returned
        hits: dict[int, bytes] = {}
        for vs, ve in chunks:
            v = max(vs, loff)
            while v < ve:
                rec, nxt = self._record_at(v)
                r_ref, r_pos = struct.unpack_from("<ii", rec, 4)
                n_cig = struct.unpack_from("<H", rec, 4 + 12 + 0)[0]
                # ref span from the CIGAR (M/D/N/=/X consume reference)
                l_name = rec[4 + 8]
                cig_off = 4 + 32 + l_name
                span = 0
                for c in struct.unpack_from(f"<{n_cig}I", rec, cig_off):
                    if (c & 0xF) in (0, 2, 3, 7, 8):
                        span += c >> 4
                r_end = r_pos + max(span, 1)
                if (r_ref == ref_id and r_pos < end and r_end > beg
                        and v not in hits):
                    hits[v] = rec
                v = nxt
        # sorted by voffset = file order
        return [hits[v] for v in sorted(hits)]


def decode_record(rec: bytes, ref_names: list[str]) -> list[str]:
    """One raw BAM record block (with length prefix) -> SAM field list —
    mirrors read_bam's per-record decoding for query results."""
    (ref_id, pos0, l_name, mapq, _bin, n_cig, flag, l_seq, next_ref,
     pnext0, tlen) = struct.unpack_from("<iiBBHHHiiii", rec, 4)
    p = 36
    qname = rec[p : p + l_name - 1].decode()
    p += l_name
    cig = struct.unpack_from(f"<{n_cig}I", rec, p)
    p += 4 * n_cig
    cigar = ("".join(f"{c >> 4}{_CIGAR_OPS[c & 0xF]}" for c in cig)
             if n_cig else "*")
    nib = rec[p : p + (l_seq + 1) // 2]
    p += (l_seq + 1) // 2
    seq = (
        _NIB_PAIR[np.frombuffer(nib, np.uint8)].tobytes()[:l_seq].decode()
        if l_seq else "*"
    )
    quals = rec[p : p + l_seq]
    p += l_seq
    qual = ("*" if not l_seq or quals.count(0xFF) == l_seq
            else quals.translate(_QUAL_TBL_INV).decode("latin-1"))
    return [
        qname, str(flag),
        ref_names[ref_id] if ref_id >= 0 else "*", str(pos0 + 1),
        str(mapq), cigar,
        ("=" if next_ref == ref_id and ref_id >= 0 else
         ref_names[next_ref] if next_ref >= 0 else "*"),
        str(pnext0 + 1), str(tlen), seq, qual,
    ] + _decode_tags(rec[p:])


def idxstats(header_text: str, records):
    """samtools-idxstats-style rows over SAM field lists:
    [(contig, length, n_mapped, n_unmapped)] per @SQ contig in header
    order, plus the trailing ('*', 0, 0, n) row for unplaced reads.
    Counts include secondary records, like samtools (which counts every
    index entry, not just primaries)."""
    names: list[str] = []
    lengths: dict[str, int] = {}
    for line in header_text.split("\n"):
        if line.startswith("@SQ"):
            f = dict(kv.split(":", 1) for kv in line.split("\t")[1:])
            names.append(f["SN"])
            lengths[f["SN"]] = int(f.get("LN", 0))
    mapped = {n: 0 for n in names}
    unmapped = {n: 0 for n in names}
    unplaced = 0
    for f in records:
        rname = f[2]
        if rname == "*" or rname not in lengths:
            unplaced += 1
        elif int(f[1]) & 0x4:
            # placed but unmapped (e.g. an unmapped mate carrying its
            # mate's RNAME) counts in the contig's unmapped column
            unmapped[rname] += 1
        else:
            mapped[rname] += 1
    return [(n, lengths[n], mapped[n], unmapped[n]) for n in names] + [
        ("*", 0, 0, unplaced)
    ]


_CIG_RE = re.compile(r"(\d+)([MIDNSHP=X])")


def _cig_ops(cigar: str):
    """[(count, op), ...] of a CIGAR string."""
    return _CIG_RE.findall(cigar)


def _cigar_cover(cigar: str, pos0: int):
    """Reference intervals [(beg, end)) that a record's aligned bases
    COVER, walking the CIGAR from pos0: M/=/X cover and consume, D/N
    consume without covering (samtools depth likewise skips deletions
    and introns), I/S/H/P consume nothing. '*' (mapped-no-CIGAR) covers
    nothing — samtools depth/pileup gives such records zero coverage."""
    if cigar == "*":
        return []
    spans = []
    p = pos0
    for n, op in _cig_ops(cigar):
        n = int(n)
        if op in "M=X":
            spans.append((p, p + n))
            p += n
        elif op in "DN":
            p += n
    return spans


_DEPTH_SKIP = 0x4 | 0x100 | 0x200 | 0x400  # unmapped/secondary/qcfail/dup


def depth(header_text: str, records, region=None, all_positions=False):
    """samtools-depth-style per-position coverage over SAM field lists:
    yields (contig, pos1, depth) rows in coordinate order. Counting
    matches samtools depth defaults: records flagged unmapped /
    secondary / QC-fail / duplicate are skipped, and only CIGAR ops
    that align a base to the reference (M/=/X) cover — deletions and
    introns consume reference without covering it.

    Vectorized as a per-contig difference array: +1 at each covered
    interval's start, -1 at its end, then cumsum — one O(L) pass per
    contig instead of per-base loops (the reference suite has no
    coverage tooling at all; its output stops at intervals,
    common/searchQueries.c:100-118).

    region: optional (contig, beg0, end0) half-open window restricting
    the OUTPUT rows (records must already be pre-filtered to candidates
    overlapping it, e.g. via IndexedBam.query or a full scan); end0 of
    None means the contig's full @SQ length.
    all_positions: also emit zero-depth rows (samtools depth -a).
    """
    names: list[str] = []
    lengths: dict[str, int] = {}
    for line in header_text.split("\n"):
        if line.startswith("@SQ"):
            f = dict(kv.split(":", 1) for kv in line.split("\t")[1:])
            names.append(f["SN"])
            lengths[f["SN"]] = int(f.get("LN", 0))
    if region is not None:
        names = [region[0]]
    starts: dict[str, list[int]] = {n: [] for n in names}
    ends: dict[str, list[int]] = {n: [] for n in names}
    for f in records:
        if int(f[1]) & _DEPTH_SKIP or f[2] not in starts:
            continue
        for b, e in _cigar_cover(f[5], int(f[3]) - 1):
            starts[f[2]].append(b)
            ends[f[2]].append(e)
    for name in names:
        length = lengths[name]
        lo, hi = (0, length) if region is None else (
            region[1], length if region[2] is None else min(region[2], length)
        )
        if hi <= lo:
            continue
        if not starts[name] and not all_positions:
            continue
        # diff spans only the emitted window [lo, hi]: a region query on
        # a 250 Mb contig must not allocate (or cumsum) O(contig).
        # Intervals clipped into the window keep their in-window cover;
        # ones entirely outside cancel at the edges (or land in the
        # trailing slot that cumsum(diff[:-1]) drops).
        diff = np.zeros(hi - lo + 1, np.int64)
        if starts[name]:
            np.add.at(diff, np.clip(np.asarray(starts[name]) - lo, 0, hi - lo), 1)
            np.add.at(diff, np.clip(np.asarray(ends[name]) - lo, 0, hi - lo), -1)
        cov = np.cumsum(diff[:-1])
        pos = (np.arange(lo, hi) if all_positions
               else lo + np.flatnonzero(cov))
        vals = cov if all_positions else cov[cov > 0]
        for p, d in zip(pos.tolist(), vals.tolist()):
            yield name, p + 1, d


_RC_TBL = bytes.maketrans(b"ACGTNacgtn", b"TGCANtgcan")


def fastq_records(records, qual_fill: str = "I"):
    """SAM field lists -> (name, seq, qual) FASTQ tuples, recovering the
    ORIGINAL reads (samtools fastq semantics): secondary (0x100) and
    supplementary (0x800) records are skipped so each read emits once,
    and minus-strand records (0x10) reverse-complement SEQ / reverse
    QUAL back to sequencer orientation. Records with no stored QUAL
    ('*') get `qual_fill` at every base (FASTQ requires a quality per
    base). Paired flags pass through for the caller to route (0x40 ->
    read1, 0x80 -> read2)."""
    for f in records:
        flag = int(f[1])
        if flag & (0x100 | 0x800):
            continue
        seq, qual = f[9], f[10]
        if seq == "*":
            continue  # no sequence stored — nothing to export
        if qual == "*":
            qual = qual_fill * len(seq)
        if flag & 0x10:
            seq = seq.encode("latin-1").translate(_RC_TBL)[::-1].decode()
            qual = qual[::-1]
        yield f[0], flag, seq, qual


def flagstat(records) -> dict[str, int]:
    """samtools-flagstat-style counters over SAM field lists."""
    c = dict(total=0, secondary=0, mapped=0, paired=0, proper=0,
             read1=0, read2=0, primary=0, primary_mapped=0)
    for f in records:
        flag = int(f[1])
        c["total"] += 1
        sec = bool(flag & 0x100)
        c["secondary"] += sec
        if not sec:
            c["primary"] += 1
        if not flag & 0x4:
            c["mapped"] += 1
            if not sec:
                c["primary_mapped"] += 1
        # samtools computes the pairing counters over PRIMARY records
        # only (secondary/supplementary lines would double-count mates)
        if flag & 0x1 and not sec:
            c["paired"] += 1
            c["proper"] += bool(flag & 0x2)
            c["read1"] += bool(flag & 0x40)
            c["read2"] += bool(flag & 0x80)
    return c


def sam_stats(records):
    """samtools-stats-style summary over SAM field lists: the SN
    (summary numbers) section plus the RL (read length) and IS (insert
    size) histograms — the subset downstream QC tooling consumes most.
    The reference suite's only output is interval pairs
    (common/searchQueries.c:100-118); this closes the alignment-QC loop
    the same way depth/flagstat/idxstats do.

    Semantics follow `samtools stats`: sequence-level counters run over
    PRIMARY records (secondary 0x100 and supplementary 0x800 excluded,
    tallied separately); "reads mapped and paired" requires BOTH mates
    mapped (a mapped read with an unmapped mate — a singleton — does not
    count, matching samtools); "bases mapped (cigar)" sums M/=/X/I of
    mapped primaries; error rate = sum(NM)/bases-mapped-cigar over
    records carrying an NM tag; insert stats run over properly-paired
    records with TLEN > 0 (each pair counted once, leftmost mate).

    Returns {"sn": [(name, value), ...] in print order,
             "rl": {length: count}, "is": {size: count}}.
    """
    n = dict(raw=0, mapped=0, unmapped=0, paired=0, proper=0,
             mapped_paired=0, dup=0, mq0=0, qcfail=0,
             first=0, last=0, secondary=0, supplementary=0)
    total_len = max_len = 0
    nm_sum = 0
    nm_bases = 0  # cigar-mapped bases of records that carried an NM tag
    bases_cigar = 0
    qual_sum = 0
    qual_n = 0
    rl: dict[int, int] = {}
    ins: dict[int, int] = {}
    for f in records:
        flag = int(f[1])
        if flag & 0x100:
            n["secondary"] += 1
            continue
        if flag & 0x800:
            n["supplementary"] += 1
            continue
        n["raw"] += 1
        L = 0 if f[9] == "*" else len(f[9])
        total_len += L
        max_len = max(max_len, L)
        if L:
            rl[L] = rl.get(L, 0) + 1
        if f[10] != "*":
            qual_sum += sum(ord(c) - 33 for c in f[10])
            qual_n += len(f[10])
        n["dup"] += bool(flag & 0x400)
        n["qcfail"] += bool(flag & 0x200)
        if flag & 0x1:
            n["paired"] += 1
            n["first"] += bool(flag & 0x40)
            n["last"] += bool(flag & 0x80)
        if flag & 0x4:
            n["unmapped"] += 1
            continue
        n["mapped"] += 1
        n["mq0"] += f[4] != "*" and int(f[4]) == 0
        if flag & 0x1:
            n["mapped_paired"] += not flag & 0x8
            if flag & 0x2:
                n["proper"] += 1
                tlen = int(f[8])
                if tlen > 0:
                    ins[tlen] = ins.get(tlen, 0) + 1
        cig = 0
        if f[5] != "*":
            cig = sum(int(num) for num, op in _cig_ops(f[5])
                      if op in "MI=X")
            bases_cigar += cig
        for tag in f[11:]:
            if tag.startswith("NM:i:"):
                nm_sum += int(tag[5:])
                nm_bases += cig
                break
    total_pairs = sum(ins.values())
    ins_avg = (sum(s * c for s, c in ins.items()) / total_pairs
               if total_pairs else 0.0)
    ins_sd = (
        (sum(c * (s - ins_avg) ** 2 for s, c in ins.items())
         / total_pairs) ** 0.5 if total_pairs else 0.0
    )
    sn = [
        ("raw total sequences", n["raw"]),
        ("filtered sequences", 0),
        ("sequences", n["raw"]),
        ("1st fragments", n["first"]),
        ("last fragments", n["last"]),
        ("reads mapped", n["mapped"]),
        ("reads mapped and paired", n["mapped_paired"]),
        ("reads unmapped", n["unmapped"]),
        ("reads properly paired", n["proper"]),
        ("reads paired", n["paired"]),
        ("reads duplicated", n["dup"]),
        ("reads MQ0", n["mq0"]),
        ("reads QC failed", n["qcfail"]),
        ("non-primary alignments", n["secondary"]),
        ("supplementary alignments", n["supplementary"]),
        ("total length", total_len),
        ("bases mapped (cigar)", bases_cigar),
        ("mismatches", nm_sum),
        ("error rate", round(nm_sum / nm_bases, 6) if nm_bases else 0.0),
        ("average length", round(total_len / n["raw"], 1) if n["raw"] else 0),
        ("maximum length", max_len),
        ("average quality", round(qual_sum / qual_n, 1) if qual_n else 0.0),
        ("insert size average", round(ins_avg, 1)),
        ("insert size standard deviation", round(ins_sd, 1)),
    ]
    return {"sn": sn, "rl": dict(sorted(rl.items())),
            "is": dict(sorted(ins.items()))}


def bedcov(header_text: str, records_by_region, regions):
    """samtools-bedcov-style rows: for each BED region (contig, beg0,
    end0), the SUM of per-base depth over the region (samtools bedcov's
    default output column). `records_by_region` is a callable
    (contig, beg0, end0) -> SAM field lists overlapping the region —
    an IndexedBam query for indexed BAMs, or a full-scan closure for
    SAM text. Yields (contig, beg0, end0, coverage_sum)."""
    for contig, beg, end in regions:
        total = 0
        recs = records_by_region(contig, beg, end)
        for _, _, d in depth(header_text, recs, region=(contig, beg, end)):
            total += d
        yield contig, beg, end, total


def read_bed(path):
    """Minimal BED3+ reader: (contig, beg0, end0, original_fields) per
    data line, extra columns preserved for echo-through (samtools bedcov
    prints them back). Comment lines skip; track/browser DIRECTIVE lines
    skip only when they do not parse as a data row, so a contig actually
    named 'track_1' (or even 'track') still works."""
    out = []
    with open(path) as fp:
        for ln, line in enumerate(fp, 1):
            line = line.rstrip("\n").rstrip("\r")
            if not line or line.lstrip().startswith("#"):
                continue
            f = line.split("\t") if "\t" in line else line.split()
            if len(f) >= 3:
                try:
                    out.append((f[0], int(f[1]), int(f[2]), f))
                    continue
                except ValueError:
                    pass
            if f and f[0] in ("track", "browser"):
                continue
            raise ValueError(
                f"{path}:{ln}: BED needs >=3 columns with integer "
                "coordinates"
            )
    return out


def _unclipped_5p(pos0: int, cigar: str, reverse: bool):
    """Unclipped 5' coordinate of a record (samtools-markdup keying):
    forward reads subtract leading soft/hard clips from POS; reverse
    reads take the reference end plus trailing clips (their 5' end is
    the right edge). Duplicates from the same template get the same
    key even when clipping differs."""
    ops = _cig_ops(cigar)
    if not reverse:
        lead = 0
        for n, op in ops:
            if op in "SH":
                lead += int(n)
            else:
                break
        return pos0 - lead
    end = pos0
    tail = 0
    seen_aligned = False
    for n, op in ops:
        if op in "MDN=X":
            end += int(n)
            seen_aligned = True
            tail = 0
        elif op in "SH":
            tail += int(n)
        # I/P consume nothing on the reference
    return end - 1 + tail if seen_aligned else pos0


def markdup(records):
    """samtools-markdup-style duplicate flagging over SAM field lists
    (any order): TEMPLATES sharing a coordinate key are grouped; every
    record of the best template keeps its flags, every record of the
    others gains 0x400. Returns (records_with_flags_updated, n_marked).

    Pairs are deduplicated at the template level: both primary mates are
    found by QNAME in the batch, the template keys on the UNORDERED pair
    of the mates' (ref, unclipped 5' pos, strand) — each end computed
    from that mate's OWN CIGAR, so differently-clipped copies of a
    template still collide (no reliance on PNEXT, which carries the
    clipped mate POS) — and the survivor is the template with the
    highest combined QUAL sum, so mates always mark together (the SAM
    spec's template-level duplicate flag). Single-end reads, singletons
    (mate unmapped), and paired records whose mate is absent from the
    batch key on their own end alone, in a separate namespace from
    pairs. Secondary/supplementary/unmapped records are never marked
    and never define a group."""
    def end_key(f, flag):
        rev = bool(flag & 0x10)
        return (f[2], _unclipped_5p(int(f[3]) - 1, f[5], rev), rev)

    def qual_sum(f):
        return (sum(ord(c) - 33 for c in f[10]) if f[10] != "*" else 0)

    mates: dict[tuple, int] = {}  # (qname, is_read1) -> record index
    for i, f in enumerate(records):
        flag = int(f[1])
        if flag & (0x4 | 0x100 | 0x800) or not flag & 0x1 or flag & 0x8:
            continue
        mates[(f[0], bool(flag & 0x40))] = i

    # groups: key -> list of (score, order, [record indices of the unit])
    groups: dict[tuple, list] = {}
    seen_pair = set()
    for i, f in enumerate(records):
        flag = int(f[1])
        if flag & (0x4 | 0x100 | 0x800):
            continue
        unit = [i]
        if flag & 0x1 and not flag & 0x8:
            j = mates.get((f[0], not flag & 0x40))
            if j is not None:
                if f[0] in seen_pair:
                    continue  # the template was grouped at its first mate
                seen_pair.add(f[0])
                unit = [i, j]
                g = records[j]
                key = ("P",) + tuple(
                    sorted([end_key(f, flag), end_key(g, int(g[1]))])
                )
                score = qual_sum(f) + qual_sum(g)
                groups.setdefault(key, []).append((score, -i, unit))
                continue
        key = ("S",) + end_key(f, flag)
        groups.setdefault(key, []).append((qual_sum(f), -i, unit))
    n_marked = 0
    out = [list(f) for f in records]
    for units in groups.values():
        if len(units) < 2:
            continue
        units.sort(reverse=True)  # best score first; earliest wins ties
        for _, _, unit in units[1:]:
            for i in unit:
                out[i][1] = str(int(out[i][1]) | 0x400)
                n_marked += 1
    return out, n_marked
