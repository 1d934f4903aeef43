"""FASTA index (.fai) build, load, and random-access region fetch: the
`samtools faidx` companion of the CLI's SAM/BAM tools, so the reference
gets the same indexed random access its BAMs get from the .bai.

Counterpart of tpufm/io/faidx.py (``build_fai`` :29, ``load_fai`` :96,
``fetch`` :107): the same .fai bytes, the same bases and the same errors
(a gzip input, ragged lines, an empty name).

The .fai format (samtools/htslib faidx spec, SAM spec annex): one
tab-separated row per sequence —
    NAME  LENGTH  OFFSET  LINEBASES  LINEWIDTH
where OFFSET is the byte offset of the first base, LINEBASES the bases
per full line, and LINEWIDTH the bytes per full line including the line
terminator (so \r\n layouts index too). Random access to bases
[beg, end) of a record then needs no scan:
    OFFSET + beg // LINEBASES * LINEWIDTH + beg % LINEBASES.

Like samtools, indexing requires every line of a sequence except the
last to have the same length — a ragged record is an error, because the
arithmetic above would silently return the wrong bases.
"""

from __future__ import annotations

import os


def build_fai(path: str) -> list[tuple[str, int, int, int, int]]:
    """Scan `path` (plain FASTA; gzip is rejected — offsets into a
    compressed stream are meaningless for random access) and write
    `path`.fai. Returns the rows [(name, length, offset, linebases,
    linewidth)]."""
    with open(path, "rb") as probe:
        if probe.read(2) == b"\x1f\x8b":
            raise ValueError(
                f"{path} is gzip-compressed; faidx needs the uncompressed "
                "FASTA (offsets into a gzip stream are not seekable)"
            )
    rows: list[tuple[str, int, int, int, int]] = []
    name = None
    length = offset = linebases = linewidth = 0
    ragged = False  # set once a short line is seen; any later line errs
    with open(path, "rb") as fp:
        pos = 0
        for raw in fp:
            pos_next = pos + len(raw)
            line = raw.rstrip(b"\r\n")
            if raw.startswith(b">"):
                if name is not None:
                    rows.append((name, length, offset, linebases, linewidth))
                # samtools: NAME is up to the first whitespace
                name = line[1:].split()[0].decode() if line[1:].split() else ""
                if not name:
                    raise ValueError(f"{path}: empty sequence name at byte {pos}")
                length, offset = 0, pos_next
                linebases = linewidth = 0
                ragged = False
            elif line:
                if name is None:
                    raise ValueError(f"{path}: sequence data before any '>' header")
                if ragged:
                    raise ValueError(
                        f"{path}: sequence {name!r} has lines of differing "
                        "length; cannot index (samtools faidx rejects this too)"
                    )
                if linebases == 0:
                    linebases, linewidth = len(line), len(raw)
                elif len(line) != linebases:
                    if len(line) > linebases:
                        raise ValueError(
                            f"{path}: sequence {name!r} has lines of differing "
                            "length; cannot index (samtools faidx rejects this too)"
                        )
                    ragged = True  # short line: legal only as the last line
                length += len(line)
            elif name is not None:
                # blank line: legal as trailing whitespace after a record,
                # but any later data line would make the offset arithmetic
                # silently wrong (samtools faidx rejects this layout too)
                if length > 0:
                    ragged = True
                else:
                    offset = pos_next  # blank between header and first base
            pos = pos_next
    if name is not None:
        rows.append((name, length, offset, linebases, linewidth))
    if not rows:
        raise ValueError(f"{path}: no FASTA records found")
    with open(path + ".fai", "w") as out:
        for r in rows:
            out.write("\t".join(map(str, r)) + "\n")
    return rows


def load_fai(path: str) -> dict[str, tuple[int, int, int, int]]:
    """`path`.fai -> {name: (length, offset, linebases, linewidth)}."""
    fai = path if path.endswith(".fai") else path + ".fai"
    out: dict[str, tuple[int, int, int, int]] = {}
    with open(fai) as fp:
        for line in fp:
            f = line.rstrip("\n").split("\t")
            out[f[0]] = (int(f[1]), int(f[2]), int(f[3]), int(f[4]))
    return out


def fetch(path: str, name: str, beg: int = 0, end: int | None = None,
          fai: dict | None = None) -> bytes:
    """Bases [beg, end) of sequence `name` (0-based, half-open), by
    seeking — no bytes outside the spanned lines are read. `end` of None
    or beyond the record clamps to its length."""
    if fai is None:
        if not os.path.exists(path + ".fai"):
            build_fai(path)
        fai = load_fai(path)
    if name not in fai:
        raise KeyError(
            f"{name!r} is not a sequence of {path} "
            f"(has: {', '.join(list(fai)[:8])}"
            + ("..." if len(fai) > 8 else "") + ")"
        )
    length, offset, linebases, linewidth = fai[name]
    end = length if end is None else min(end, length)
    beg = max(beg, 0)
    if end <= beg:
        return b""
    if linebases == 0:  # empty record
        return b""
    start_byte = offset + (beg // linebases) * linewidth + beg % linebases
    last = end - 1
    end_byte = offset + (last // linebases) * linewidth + last % linebases + 1
    with open(path, "rb") as fp:
        fp.seek(start_byte)
        raw = fp.read(end_byte - start_byte)
    # strip the line terminators that fall inside the span
    return raw.replace(b"\r", b"").replace(b"\n", b"")
