"""BAM v1: the bgzf-compressed binary form of the SAM records, and a reader.

Counterpart of tpufm/io/bam.py (``reg2bin`` :52, ``bgzf_compress`` :74,
``bgzf_member_at``, ``bgzf_decompress``, the tag and CIGAR codecs,
``sam_to_bam`` :312, ``write_bam`` :353, ``read_bam`` :358) and of
``_read_sam_or_bam`` (tpufm/cli.py:1494), byte for byte:
the same SAM text and the same deflate level (``TPUFM_BGZF_LEVEL``, read as
tpufm reads it) give the same BAM bytes. BAM is made by encoding the SAM
text that ``host/sam.py`` writes, so one implementation decides the
records and two serialize them. The encoder follows the SAM/BAM
specification v1.6, section 4: bgzf framing (gzip members with the BC
extra subfield, then the fixed 28-byte EOF member), the header block, and
each record's binary layout (reg2bin's bin, 4-bit SEQ, packed CIGAR,
typed tags). ``read_bam`` decodes a file back to SAM fields, for the tests
and checks that hold the BAM against the SAM text it came from.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

# SAM spec v1.6 4.2.3: 4-bit encoding of bases, '=ACMGRSVTWYHKDBN'
_SEQ_CODE = {b: i for i, b in enumerate("=ACMGRSVTWYHKDBN")}
_SEQ_CHAR = "=ACMGRSVTWYHKDBN"
# byte translation tables for the per-record loops (a loop over each
# character of SEQ and QUAL would lead sam_to_bam's time)
_NIB_TBL = bytes(
    _SEQ_CODE.get(chr(b).upper(), 15) for b in range(256)
)
_QUAL_TBL = bytes((b - 33) & 0xFF for b in range(256))
_QUAL_TBL_INV = bytes((b + 33) & 0xFF for b in range(256))
# nibble -> two ASCII chars, for the decode side
_NIB_PAIR = np.array(
    [
        (ord(_SEQ_CHAR[b >> 4]) << 8) | ord(_SEQ_CHAR[b & 0xF])
        for b in range(256)
    ],
    dtype=">u2",
)
_CIGAR_OPS = "MIDNSHP=X"
_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)


def reg2bin(beg: int, end: int) -> int:
    """SAM spec v1.6 5.3: UCSC binning index bin of [beg, end) (0-based)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


#: fixed uncompressed bytes per bgzf member: the virtual offsets of a BAI
#: index (host/bam_index.py) depend on every member but the last holding
#: exactly this many
BGZF_STEP = 0xE000


def bgzf_compress(
    data: bytes,
    member_offsets: list[int] | None = None,
    level: int | None = None,
) -> bytes:
    """bgzf-frame `data`: <=64 KiB-uncompressed gzip members, each with
    the BC extra subfield holding (member length - 1), then the EOF
    marker member (SAM spec v1.6 4.1). When `member_offsets` is given it
    is filled with each member's COMPRESSED start offset (member i holds
    uncompressed bytes [i*BGZF_STEP, (i+1)*BGZF_STEP)) — the coffset half
    of BAI virtual file offsets — plus ONE trailing sentinel entry: the
    EOF marker member's compressed offset, so an uncompressed offset one
    past the final byte (a chunk END when the stream length is an exact
    BGZF_STEP multiple) still maps to a valid, correctly-ordered voffset.

    `level` is the deflate level (default 6, samtools' default; set per
    call or for the process with TPUFM_BGZF_LEVEL, 0-9; a lower level
    compresses faster into a larger file)."""
    if level is None:
        import os

        raw = os.environ.get("TPUFM_BGZF_LEVEL", "6")
        try:
            level = int(raw)
        except ValueError:
            level = -1
        if not 0 <= level <= 9:
            raise ValueError(
                f"TPUFM_BGZF_LEVEL must be an integer 0-9, got {raw!r}"
            )
    out = []
    # keep the COMPRESSED member under 2^16 too: 0xE000 of compressible
    # text deflates far below that, and the header math is checked below
    step = BGZF_STEP
    pos = 0
    for off in range(0, len(data), step) or [0]:
        if member_offsets is not None:
            member_offsets.append(pos)
        chunk = data[off : off + step]
        co = zlib.compressobj(level, zlib.DEFLATED, -15)
        payload = co.compress(chunk) + co.flush()
        bsize = len(payload) + 25 + 1  # header(12)+XLEN payload(6)+crc/isize(8)
        if bsize > 0xFFFF:
            raise ValueError("bgzf member overflow (incompressible block)")
        member = (
            struct.pack(
                "<4BI2B2s2sHH",
                0x1F, 0x8B, 8, 4,  # gzip magic, deflate, FEXTRA
                0, 0, 0xFF,  # mtime, XFL, OS=unknown
                b"\x06\x00"[0:2], b"BC", 2, bsize - 1,
            )
            + payload
            + struct.pack("<II", zlib.crc32(chunk), len(chunk) & 0xFFFFFFFF)
        )
        out.append(member)
        pos += len(member)
    if member_offsets is not None:
        member_offsets.append(pos)  # the EOF member's offset (sentinel)
    out.append(_BGZF_EOF)
    return b"".join(out)


def bgzf_member_at(blob: bytes, off: int) -> tuple[bytes, int]:
    """Decode the single bgzf member starting at compressed offset `off`,
    validating BSIZE/CRC; returns (uncompressed chunk, next member's
    offset). The random-access primitive behind BAI virtual offsets."""
    if blob[off : off + 4] != b"\x1f\x8b\x08\x04":
        raise ValueError(f"not a bgzf member at offset {off}")
    xlen = struct.unpack_from("<H", blob, off + 10)[0]
    extra = blob[off + 12 : off + 12 + xlen]
    bsize = None
    e = 0
    while e < len(extra):
        si1, si2, slen = extra[e], extra[e + 1], struct.unpack_from(
            "<H", extra, e + 2
        )[0]
        if (si1, si2) == (ord("B"), ord("C")):
            bsize = struct.unpack_from("<H", extra, e + 4)[0] + 1
        e += 4 + slen
    if bsize is None:
        raise ValueError("bgzf member missing BC subfield")
    payload = blob[off + 12 + xlen : off + bsize - 8]
    crc, isize = struct.unpack_from("<II", blob, off + bsize - 8)
    chunk = zlib.decompress(payload, -15)
    if zlib.crc32(chunk) != crc or len(chunk) & 0xFFFFFFFF != isize:
        raise ValueError("bgzf member CRC/ISIZE mismatch")
    return chunk, off + bsize


def bgzf_decompress(blob: bytes) -> bytes:
    """Inverse of bgzf_compress, validating per-member BSIZE/CRC."""
    out, off = [], 0
    while off < len(blob):
        chunk, off = bgzf_member_at(blob, off)
        out.append(chunk)
    return b"".join(out)


def _encode_tag(tag: str) -> bytes:
    """One SAM optional field 'TAG:TYPE:VALUE' -> BAM bytes. Integers
    ('i') are emitted as int32 'i' regardless of magnitude class — always
    valid, and what htslib emits by default for NM-scale values."""
    name, typ, val = tag.split(":", 2)
    if len(name) != 2:
        raise ValueError(f"bad tag name {name!r}")
    head = name.encode()
    if typ == "i":
        return head + b"i" + struct.pack("<i", int(val))
    if typ == "A":
        return head + b"A" + val[:1].encode()
    if typ == "f":
        return head + b"f" + struct.pack("<f", float(val))
    if typ in ("Z", "H"):
        return head + typ.encode() + val.encode() + b"\x00"
    if typ == "B":
        sub = val[0]
        nums = [v for v in val[2:].split(",") if v != ""]
        fmt = {"c": "b", "C": "B", "s": "h", "S": "H", "i": "i", "I": "I",
               "f": "f"}[sub]
        conv = float if sub == "f" else int
        return (head + b"B" + sub.encode()
                + struct.pack("<I", len(nums))
                + b"".join(struct.pack("<" + fmt, conv(v)) for v in nums))
    raise ValueError(f"unsupported tag type {typ!r}")


def _decode_tags(buf: bytes) -> list[str]:
    out, off = [], 0
    while off < len(buf):
        name = buf[off : off + 2].decode()
        typ = chr(buf[off + 2])
        off += 3
        if typ in "cC":
            v = struct.unpack_from("<b" if typ == "c" else "<B", buf, off)[0]
            out.append(f"{name}:i:{v}")
            off += 1
        elif typ in "sS":
            v = struct.unpack_from("<h" if typ == "s" else "<H", buf, off)[0]
            out.append(f"{name}:i:{v}")
            off += 2
        elif typ in "iI":
            v = struct.unpack_from("<i" if typ == "i" else "<I", buf, off)[0]
            out.append(f"{name}:i:{v}")
            off += 4
        elif typ == "f":
            out.append(f"{name}:f:{struct.unpack_from('<f', buf, off)[0]}")
            off += 4
        elif typ == "A":
            out.append(f"{name}:A:{chr(buf[off])}")
            off += 1
        elif typ in "ZH":
            end = buf.index(0, off)
            out.append(f"{name}:{typ}:{buf[off:end].decode()}")
            off = end + 1
        elif typ == "B":
            sub = chr(buf[off])
            n = struct.unpack_from("<I", buf, off + 1)[0]
            fmt, size = {"c": ("b", 1), "C": ("B", 1), "s": ("h", 2),
                         "S": ("H", 2), "i": ("i", 4), "I": ("I", 4),
                         "f": ("f", 4)}[sub]
            vals = struct.unpack_from(f"<{n}{fmt}", buf, off + 5)
            out.append(f"{name}:B:{sub}," + ",".join(str(v) for v in vals))
            off += 5 + n * size
        else:
            raise ValueError(f"unsupported tag type {typ!r}")
    return out


def _parse_cigar(cigar: str) -> list[tuple[int, int]]:
    ops, n = [], 0
    for ch in cigar:
        if ch.isdigit():
            n = n * 10 + ord(ch) - 48
        else:
            ops.append((n, _CIGAR_OPS.index(ch)))
            n = 0
    return ops


def _encode_record(fields: list[str], ref_ids: dict[str, int]):
    """-> (record bytes, (ref_id, pos0, ref_end)) — the placement triple
    feeds ``build_bai`` (host/bam_index.py); ref_end is reg2bin's
    half-open end (pos0 + max(reference span, 1))."""
    (qname, flag, rname, pos, mapq, cigar, rnext, pnext, tlen, seq,
     qual) = fields[:11]
    flag, pos, mapq = int(flag), int(pos), int(mapq)
    pnext, tlen = int(pnext), int(tlen)
    ref_id = ref_ids[rname] if rname != "*" else -1
    pos0 = pos - 1  # BAM is 0-based; SAM '0' (unmapped) -> -1
    if rnext == "=":
        next_ref = ref_id
    elif rnext == "*":
        next_ref = -1
    else:
        next_ref = ref_ids[rnext]
    ops = [] if cigar == "*" else _parse_cigar(cigar)
    ref_span = sum(n for n, op in ops if op in (0, 2, 3, 7, 8))
    bam_bin = reg2bin(pos0, pos0 + max(ref_span, 1)) if pos0 >= 0 else 0
    l_seq = 0 if seq == "*" else len(seq)
    name_z = qname.encode() + b"\x00"
    body = [
        struct.pack(
            "<iiBBHHHiiii",
            ref_id, pos0, len(name_z), mapq, bam_bin, len(ops), flag,
            l_seq, next_ref, pnext - 1, tlen,
        ),
        name_z,
        b"".join(struct.pack("<I", (n << 4) | op) for n, op in ops),
    ]
    if l_seq:
        # latin-1 + replace keeps one byte per char for ANY str (a stray
        # non-ASCII base becomes '?' -> nibble 15 = 'N', like the old
        # per-char dict lookup), so the record layout can't desync
        nib = np.frombuffer(
            seq.encode("latin-1", "replace").translate(_NIB_TBL), np.uint8
        )
        if l_seq % 2:
            nib = np.append(nib, np.uint8(0))
        body.append(((nib[0::2] << 4) | nib[1::2]).tobytes())
    else:
        body.append(b"")
    if qual != "*" and len(qual) != l_seq:
        raise ValueError(
            f"QUAL length {len(qual)} != SEQ length {l_seq} for read "
            f"{qname!r} — the BAM record layout requires them equal"
        )
    body.append(
        b"\xff" * l_seq if qual == "*"
        else qual.encode("latin-1", "replace").translate(_QUAL_TBL)
    )
    body.extend(_encode_tag(t) for t in fields[11:])
    rec = b"".join(body)
    return (
        struct.pack("<I", len(rec)) + rec,
        (ref_id, pos0, pos0 + max(ref_span, 1)),
    )


def sam_to_bam(sam_text: str, record_meta: list | None = None) -> bytes:
    """Encode full SAM text (header + alignment lines) to an
    UNCOMPRESSED BAM stream (magic + header + records); wrap with
    bgzf_compress / write via write_bam for the on-disk format.

    When `record_meta` is given it is filled with one
    (ustart, uend, ref_id, pos0, ref_end) tuple per record — uncompressed
    byte extent plus placement — for ``build_bai`` (host/bam_index.py)."""
    header_lines = []
    refs: list[tuple[str, int]] = []
    records = []
    ref_ids: dict[str, int] = {}
    for line in sam_text.split("\n"):
        if not line:
            continue
        if line.startswith("@"):
            header_lines.append(line)
            if line.startswith("@SQ"):
                f = dict(
                    kv.split(":", 1) for kv in line.split("\t")[1:]
                )
                ref_ids[f["SN"]] = len(refs)
                refs.append((f["SN"], int(f["LN"])))
        else:
            records.append(line.split("\t"))
    text = ("\n".join(header_lines) + "\n").encode()
    out = [b"BAM\x01", struct.pack("<i", len(text)), text,
           struct.pack("<i", len(refs))]
    for name, ln in refs:
        nz = name.encode() + b"\x00"
        out.append(struct.pack("<i", len(nz)) + nz + struct.pack("<i", ln))
    upos = sum(len(b) for b in out)
    for f in records:
        rec, place = _encode_record(f, ref_ids)
        if record_meta is not None:
            record_meta.append((upos, upos + len(rec)) + place)
        upos += len(rec)
        out.append(rec)
    return b"".join(out)


def write_bam(path: str, sam_text: str) -> None:
    """``sam_text`` encoded, bgzf-framed and written to ``path``."""
    with open(path, "wb") as fp:
        fp.write(bgzf_compress(sam_to_bam(sam_text)))


def read_bam(path: str):
    """Decode a BAM file back to (header_text, [SAM-field lists]) for
    differential tests against the SAM writer's text."""
    raw = bgzf_decompress(open(path, "rb").read())
    if raw[:4] != b"BAM\x01":
        raise ValueError("bad BAM magic")
    l_text = struct.unpack_from("<i", raw, 4)[0]
    text = raw[8 : 8 + l_text].decode()
    off = 8 + l_text
    n_ref = struct.unpack_from("<i", raw, off)[0]
    off += 4
    names = []
    for _ in range(n_ref):
        l_name = struct.unpack_from("<i", raw, off)[0]
        names.append(raw[off + 4 : off + 4 + l_name - 1].decode())
        off += 4 + l_name + 4
    records = []
    while off < len(raw):
        (block,) = struct.unpack_from("<I", raw, off)
        rec = raw[off + 4 : off + 4 + block]
        off += 4 + block
        (ref_id, pos0, l_name, mapq, _bin, n_cig, flag, l_seq, next_ref,
         pnext0, tlen) = struct.unpack_from("<iiBBHHHiiii", rec)
        p = 32
        qname = rec[p : p + l_name - 1].decode()
        p += l_name
        cig = struct.unpack_from(f"<{n_cig}I", rec, p)
        p += 4 * n_cig
        cigar = (
            "".join(f"{c >> 4}{_CIGAR_OPS[c & 0xF]}" for c in cig)
            if n_cig else "*"
        )
        nib = rec[p : p + (l_seq + 1) // 2]
        p += (l_seq + 1) // 2
        seq = (
            _NIB_PAIR[np.frombuffer(nib, np.uint8)]
            .tobytes()[:l_seq].decode()
            if l_seq else "*"
        )
        quals = rec[p : p + l_seq]
        p += l_seq
        qual = (
            "*" if not l_seq or quals.count(0xFF) == l_seq
            else quals.translate(_QUAL_TBL_INV).decode("latin-1")
        )
        fields = [
            qname, str(flag),
            names[ref_id] if ref_id >= 0 else "*", str(pos0 + 1),
            str(mapq), cigar,
            ("=" if next_ref == ref_id and ref_id >= 0 else
             names[next_ref] if next_ref >= 0 else "*"),
            str(pnext0 + 1), str(tlen), seq, qual,
        ] + _decode_tags(rec[p:])
        records.append(fields)
    return text, records


def read_sam_or_bam(path: str) -> str:
    """SAM text from a SAM or a BAM file, told apart by the bgzf magic
    (tpufm/cli.py:1494)."""
    with open(path, "rb") as fp:
        magic = fp.read(4)
    if magic == b"\x1f\x8b\x08\x04":
        header, records = read_bam(path)
        return header + "".join("\t".join(r) + "\n" for r in records)
    with open(path) as fp:
        return fp.read()
