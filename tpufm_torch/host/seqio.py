"""Sequences and results on disk, byte-compatible with tpufm's files.

Counterparts of tpufm/utils/encoding.py (2-bit codes A=0 C=1 G=2 T=3),
tpufm/io/fasta.py (``read_reference`` :37, ``write_reference`` :65,
``load_queries`` :125, ``load_queries_varlen`` :154), tpufm/io/genreads.py
(``generate_reads`` :13, ``generate_read_pairs`` :30, ``write_reads_fasta`` :92) and tpufm/io/results.py
(``write_results`` :10).
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
