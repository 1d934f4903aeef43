"""Sequences and results on disk, byte-compatible with tpufm's files.

Counterparts of tpufm/utils/encoding.py (2-bit codes A=0 C=1 G=2 T=3),
tpufm/io/fasta.py (``read_reference`` :37, ``write_reference`` :65,
``load_queries`` :125, ``load_queries_varlen`` :154, ``sniff_reads`` :191,
``PackedStrs`` :203, ``load_query_names[_packed]`` :298 / :243,
``load_query_quals[_packed]`` :262 / :251), tpufm/io/genreads.py
(``generate_reads`` :13, ``generate_read_pairs`` :30, ``write_reads_fasta`` :92) and tpufm/io/results.py
(``write_results`` :10, ``load_results`` :18).
"""

from __future__ import annotations

import gzip

import numpy as np

# ASCII -> 2-bit code by the bit formula of the reference tools:
# bit1 = b & 4; bit0 = bit1 ? (b & 2) ^ 2 : b & 2; code = (bit1 | bit0) >> 1.
# A/a -> 0, C/c -> 1, G/g -> 2, T/t -> 3, and any other byte by the same rule.
_b = np.arange(256, dtype=np.uint32)
_ENCODE = (((_b & 4) | np.where(_b & 4, (_b & 2) ^ 2, _b & 2)) >> 1).astype(np.uint8).tobytes()
_DECODE = bytes(b"ACGT"[i & 3] for i in range(256))
_LINE = 70

#: pad byte on the left of right-aligned variable-length reads, outside the
#: 0-3 code alphabet (tpufm/engine/xla.py:309)
VARLEN_PAD = 0xFF


def encode_bases(seq) -> np.ndarray:
    """ASCII bytes / str / uint8 array -> uint8 codes in {0, 1, 2, 3}."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    if not isinstance(seq, (bytes, bytearray)):
        seq = np.ascontiguousarray(seq, dtype=np.uint8).tobytes()
    return np.frombuffer(bytes(seq).translate(_ENCODE), dtype=np.uint8)


def decode_bases(codes) -> bytes:
    """uint8 codes 0..3 -> ASCII bytes."""
    return np.ascontiguousarray(codes, dtype=np.uint8).tobytes().translate(_DECODE)


def reverse_complement(codes: np.ndarray) -> np.ndarray:
    """Reverse complement along the last axis: rc(q) = 3 - q[..., ::-1]."""
    codes = np.asarray(codes, dtype=np.uint8)
    return (np.uint8(3) - codes[..., ::-1]).astype(np.uint8)


def reverse_complement_varlen(batch: np.ndarray) -> np.ndarray:
    """Reverse complement of each read of a right-aligned ``VARLEN_PAD``-padded
    batch [B, Lmax], kept right-aligned: the pad stays on the left
    (tpufm/utils/encoding.py:64)."""
    batch = np.asarray(batch, dtype=np.uint8)
    B, L = batch.shape
    rev = batch[:, ::-1]  # the real characters now on the left
    comp = np.where(rev != VARLEN_PAD, np.uint8(3) - rev, VARLEN_PAD).astype(np.uint8)
    src = np.arange(L)[None, :] - (L - (batch != VARLEN_PAD).sum(axis=1))[:, None]
    return np.where(src >= 0, comp[np.arange(B)[:, None], np.clip(src, 0, L - 1)],
                    VARLEN_PAD).astype(np.uint8)


def _open(path):
    """A file for reading, gunzipped when it starts with the gzip magic."""
    with open(path, "rb") as probe:
        gz = probe.read(2) == b"\x1f\x8b"
    return gzip.open(path, "rb") if gz else open(path, "rb")


def read_reference(path, refsize: int | None = None) -> np.ndarray:
    """The first ``refsize`` bases of a (multi-)FASTA file as 2-bit codes
    (header lines skipped, records concatenated)."""
    chunks, total = [], 0
    with _open(path) as fp:
        if not fp.readline().startswith(b">"):
            raise ValueError(f"{path}: not a FASTA file (missing '>' header)")
        for line in fp:
            seq = line.strip()
            if not seq or line.startswith(b">"):
                continue
            chunks.append(seq)
            total += len(seq)
            if refsize is not None and total >= refsize:
                break
    data = b"".join(chunks)
    if refsize is not None:
        if len(data) < refsize:
            raise ValueError(f"{path}: reference has {len(data)} bases, need {refsize}")
        data = data[:refsize]
    return encode_bases(data)


def write_reference(path, seq: bytes | str) -> None:
    """One FASTA record: header '> <size>', 70-column lines."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    with open(path, "wb") as fp:
        fp.write(b"> %d" % len(seq))
        for off in range(0, len(seq), _LINE):
            fp.write(b"\n" + seq[off:off + _LINE])
        fp.write(b"\n")


def _reads(path, num_queries: int | None, query_len: int | None = None):
    """The stripped non-empty sequence lines of a .qry/FASTA file (every
    non-empty non-header line is one read) or a FASTQ file (4-line records,
    detected by a leading '@'), either optionally gzipped: at most
    ``num_queries`` of them, and exactly that many, each ``query_len`` long
    when given, or ValueError."""
    reads = []
    with _open(path) as fp:
        fastq = fp.read(1) == b"@"
        fp.seek(0)
        while num_queries is None or len(reads) < num_queries:
            line = fp.readline()
            if not line:
                break
            if fastq:
                line = fp.readline()
                fp.readline()
                fp.readline()
            elif line.startswith(b">"):
                continue
            seq = line.strip()
            if not seq:
                continue
            if query_len is not None and len(seq) != query_len:
                raise ValueError(f"{path}: read of length {len(seq)}, expected {query_len}")
            reads.append(seq)
    if num_queries is not None and len(reads) < num_queries:
        raise ValueError(f"{path}: only {len(reads)} reads, need {num_queries}")
    return reads


def load_queries(path, query_len: int, num_queries: int | None = None) -> np.ndarray:
    """uint8 codes [num_queries, query_len] from a .qry/FASTA or FASTQ file,
    either optionally gzipped."""
    reads = _reads(path, num_queries, query_len)
    return encode_bases(b"".join(reads)).reshape(len(reads), query_len)


def load_queries_varlen(path, num_queries: int | None = None) -> np.ndarray:
    """uint8 codes [num_queries, max_len] of a mixed-length .qry/FASTA or
    FASTQ file, either optionally gzipped: each read right-aligned with
    ``VARLEN_PAD`` on the left, the shape ``SearchEngine.search_varlen``
    takes (backward search reads from the end, so every read's suffix sits
    in the same columns)."""
    reads = _reads(path, num_queries)
    if not reads:
        raise ValueError(f"{path}: no reads found")
    lens = np.fromiter(map(len, reads), np.int64, len(reads))
    max_len = int(lens.max())
    out = np.full((len(reads), max_len), VARLEN_PAD, dtype=np.uint8)
    # the mask enumerates cells row-major, in the joined reads' order
    out[np.arange(max_len)[None, :] >= max_len - lens[:, None]] = encode_bases(b"".join(reads))
    return out


def fasta_num_bases(path) -> int:
    """Sequence bases of a (multi-)FASTA file, optionally gzipped: what
    ``read_reference`` gives with no refsize (tpufm/cli.py:1157)."""
    with _open(path) as fp:
        return sum(len(line.strip()) for line in fp if not line.startswith(b">"))


def _seq_extents(data: bytes):
    """(start, end) int64 byte offsets of every read's sequence in a
    .qry/FASTA or FASTQ file's bytes, in file order, by one numpy pass
    (tpufm/io/fasta.py:76): FASTQ takes line 4i+1 of each record and skips
    empty sequences, FASTA every non-empty non-header line; \\r\\n endings
    and a missing last newline are allowed."""
    arr = np.frombuffer(data, dtype=np.uint8)
    nl = np.flatnonzero(arr == 10)
    if len(arr) and (len(nl) == 0 or nl[-1] != len(arr) - 1):
        nl = np.append(nl, len(arr))  # a newline after the last line
    if len(nl) == 0:
        z = np.zeros(0, np.int64)
        return z, z
    starts = np.empty(len(nl), np.int64)
    starts[0] = 0
    starts[1:] = nl[:-1] + 1
    ends = nl.astype(np.int64)
    ends = ends - ((ends > starts) & (arr[np.maximum(ends - 1, 0)] == 13))
    if data[:1] == b"@":
        s, e = starts[1::4], ends[1::4]
        keep = e > s
        return s[keep], e[keep]
    first = arr[np.minimum(starts, len(arr) - 1)]
    is_seq = (ends > starts) & (first != ord(">"))
    return starts[is_seq], ends[is_seq]


def sniff_reads(path):
    """(shortest length, longest length, read count) of a .qry/FASTA or
    FASTQ file, optionally gzipped, under the loaders' record rules;
    (None, 0, 0) when it holds no read."""
    with _open(path) as fp:
        s, e = _seq_extents(fp.read())
    if not len(s):
        return None, 0, 0
    lens = e - s
    return int(lens.min()), int(lens.max()), len(s)


class PackedStrs:
    """Strings joined into one utf-8 buffer with int64 offsets [n + 1], the
    shape the native SAM emitter reads without a copy (tpufm/io/fasta.py:203).
    Indexes and iterates as str; an empty entry is '' (no quality)."""

    __slots__ = ("buf", "off")

    def __init__(self, buf: bytes, off):
        self.buf = buf
        self.off = np.ascontiguousarray(off, dtype=np.int64)

    @classmethod
    def join(cls, strs) -> "PackedStrs":
        bufs = [s.encode() for s in strs]
        off = np.zeros(len(bufs) + 1, np.int64)
        np.cumsum([len(b) for b in bufs], out=off[1:])
        return cls(b"".join(bufs), off)

    def __len__(self):
        return len(self.off) - 1

    def __getitem__(self, i):
        return self.buf[self.off[i]:self.off[i + 1]].decode()

    def __iter__(self):
        o = self.off.tolist()
        for a, b in zip(o, o[1:]):
            yield self.buf[a:b].decode()


def load_query_names(path, num_queries: int | None = None) -> list[str]:
    """One QNAME per read of a .qry/FASTA or FASTQ file, optionally gzipped,
    under the loaders' record rules (tpufm/io/fasta.py:298): the first
    token of the read's header (every line of a multi-line FASTA record
    takes its record's), ``r<i>`` where the header has none or the read
    has no header, and ``r<i>`` for the reads missing up to
    ``num_queries``."""
    def token(header: bytes | None, i: int) -> str:
        t = header[1:].split() if header is not None else []
        return t[0].decode("ascii", "replace") if t else f"r{i}"

    names = []
    with _open(path) as fp:
        fastq = fp.read(1) == b"@"
        fp.seek(0)
        header = None
        while num_queries is None or len(names) < num_queries:
            line = fp.readline()
            if not line:
                break
            if fastq:
                header, line = line, fp.readline()
                fp.readline()
                fp.readline()
            elif line.startswith(b">"):
                header = line
                continue
            if line.strip():
                names.append(token(header, len(names)))
    if num_queries is not None:
        names += [f"r{i}" for i in range(len(names), num_queries)]
    return names


def load_query_quals(path, num_queries: int | None = None):
    """Per-read Phred+33 quality strings of a FASTQ file, optionally
    gzipped, for SAM's QUAL (tpufm/io/fasta.py:262), or None for a
    .qry/FASTA file. A read whose quality line is not as long as its
    sequence gets None (the writers emit '*'), as do the reads missing up
    to ``num_queries``. Decoded as latin-1, so every byte survives."""
    quals = []
    with _open(path) as fp:
        if fp.read(1) != b"@":
            return None
        fp.seek(0)
        while (num_queries is None or len(quals) < num_queries) and fp.readline():
            seq = fp.readline().strip()
            fp.readline()
            qual = fp.readline().strip()
            if seq:
                quals.append(qual.decode("latin-1") if len(qual) == len(seq) else None)
    if num_queries is not None:
        quals += [None] * (num_queries - len(quals))
    return quals


def load_query_names_packed(path, num_queries: int | None = None) -> PackedStrs:
    """``load_query_names`` as one ``PackedStrs`` (tpufm/io/fasta.py:243)."""
    return PackedStrs.join(load_query_names(path, num_queries))


def load_query_quals_packed(path, num_queries: int | None = None) -> PackedStrs | None:
    """``load_query_quals`` as one ``PackedStrs``, '' for a read without
    qualities, or None for a .qry/FASTA file (tpufm/io/fasta.py:251)."""
    quals = load_query_quals(path, num_queries)
    return None if quals is None else PackedStrs.join(q or "" for q in quals)


def generate_reads(codes: np.ndarray, length: int, num: int, seed: int = 0,
                   return_starts: bool = False):
    """``num`` reads of ``length`` bases sampled uniformly from ``codes``
    with numpy's default_rng(seed): uint8 [num, length] (and the int64
    start positions)."""
    n = codes.shape[0]
    if length > n:
        raise ValueError(f"read length {length} exceeds reference size {n}")
    starts = np.random.default_rng(seed).integers(0, n - length + 1, size=num, dtype=np.int64)
    reads = codes[starts[:, None] + np.arange(length, dtype=np.int64)[None, :]]
    return (reads, starts) if return_starts else reads


def generate_read_pairs(codes: np.ndarray, length: int, num: int, insert_min: int,
                        insert_max: int, seed: int = 0, return_truth: bool = False):
    """``num`` FR read pairs sampled with numpy's default_rng(seed): per
    pair a fragment of uniform length in [max(insert_min, length),
    insert_max], placed uniformly; R1 is its head and R2 the reverse
    complement of its tail, swapped on odd pairs (R1 on the minus strand).
    Returns (r1, r2) uint8 [num, length] and, with ``return_truth``, (left
    start int64 [num], right start int64 [num], strand uint8 [num], 1 =
    minus)."""
    n = codes.shape[0]
    lo = max(insert_min, length)
    if not (length <= lo <= insert_max <= n):
        raise ValueError(
            f"need read length {length} <= insert range [{insert_min}, "
            f"{insert_max}] <= reference size {n}"
        )
    rng = np.random.default_rng(seed)
    frag = rng.integers(lo, insert_max + 1, size=num, dtype=np.int64)
    starts = rng.integers(0, n - frag + 1, dtype=np.int64)
    idx = np.arange(length, dtype=np.int64)[None, :]
    head = codes[starts[:, None] + idx]
    tail_rc = reverse_complement(codes[(starts + frag - length)[:, None] + idx])
    minus = (np.arange(num) % 2).astype(bool)
    r1 = np.where(minus[:, None], tail_rc, head)
    r2 = np.where(minus[:, None], head, tail_rc)
    if not return_truth:
        return r1, r2
    return r1, r2, (starts, starts + frag - length, minus.astype(np.uint8))


def write_reads_fasta(path, reads: np.ndarray, starts=None) -> None:
    """Reads as multi-FASTA with headers '>ridN start-end'."""
    n, length = reads.shape
    starts = np.zeros(n, np.int64) if starts is None else np.asarray(starts, np.int64)
    chunk = 1 << 16
    with open(path, "wb") as fp:
        for base in range(0, n, chunk):
            seqs = decode_bases(reads[base:base + chunk])
            fp.write(b"".join(
                b">rid%d %d-%d\n%s\n" % (base + j, s, s + length, seqs[j * length:(j + 1) * length])
                for j, s in enumerate(starts[base:base + chunk].tolist())
            ))


def write_results(path, intervals: np.ndarray) -> None:
    """The .res text format: the interval count, then one 'L R' per line."""
    intervals = np.asarray(intervals)
    with open(path, "wb") as fp:
        fp.write(f"{intervals.shape[0]}\n".encode())
        np.savetxt(fp, intervals, fmt="%u %u")


def load_results(path) -> np.ndarray:
    """uint32 [n, 2] intervals of a .res file (``write_results``' format)."""
    with open(path) as fp:
        n = int(fp.readline())
        return np.loadtxt(fp, dtype=np.uint32, max_rows=n).reshape(n, 2)
