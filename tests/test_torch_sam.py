"""The port's SAM host side against tpufm's: read names, qualities and
sizing (``tpufm_torch.host.seqio``), the record map (``host/contigs.py``),
edit re-alignment (``host/align.py``) and the SAM writers (``host/sam.py``,
with the native emitter ``csrc/samemit.cpp`` and its Python loop), each on
the same seeded inputs. Text and arrays compare exactly (tolerance 0)."""

import gzip

import numpy as np
import pytest

from tpufm import cli as jax_cli
from tpufm.io import contigs as jax_contigs
from tpufm.io import fasta as jax_fasta
from tpufm.io import sam as jax_sam
from tpufm.utils.align import edit_alignments as jax_edit_alignments
from tpufm.utils.encoding import reverse_complement_varlen as jax_rc_varlen
from tpufm_torch.host import contigs, sam, seqio
from tpufm_torch.host.align import edit_alignments

RECORDS = (1500, 0, 900, 2100, 700)  # the empty record is not listed in the map


def _fasta(path, recs, headers=None, width=60, gz=False):
    out = []
    for i, r in enumerate(recs):
        out.append(headers[i] if headers else b">chr%d some description" % (i + 1))
        s = seqio.decode_bases(r)
        out.extend(s[o:o + width] for o in range(0, len(s), width))
    data = b"\n".join(out) + b"\n"
    (path.write_bytes(gzip.compress(data)) if gz else path.write_bytes(data))
    return path


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    rng = np.random.default_rng(41)
    recs = [rng.integers(0, 4, size=n, dtype=np.uint8) for n in RECORDS]
    fa = _fasta(tmp_path_factory.mktemp("sam") / "g.fa", recs)
    return np.concatenate(recs), fa


def _phred(rng, n):
    return "".join(chr(33 + int(x)) for x in rng.integers(0, 41, size=n))


def _write_reads(path, reads, kind, rng):
    """Reads as FASTA (with a nameless header and a multi-line record),
    FASTQ (with an empty record and a malformed quality), or gzip of either."""
    lines = []
    fastq = kind.startswith("fastq")
    for i, r in enumerate(reads):
        s = seqio.decode_bases(r).decode()
        if fastq:
            q = _phred(rng, len(s))
            if i == 3:
                q = q[:-1]  # malformed: one short
            lines += [f"@read{i} extra", s, "+", q]
            if i == 5:
                lines += ["@empty", "", "+", ""]
        elif i == 2:
            lines += [">", s]
        elif i == 4:
            lines += [f">multi{i}", s[:10], s[10:]]
        else:
            lines += [f">read{i} x", s]
    data = ("\n".join(lines) + "\n").encode()
    path.write_bytes(gzip.compress(data) if kind.endswith("gz") else data)
    return path


@pytest.mark.parametrize("kind", ["fasta", "fastq", "fasta-gz", "fastq-gz"])
@pytest.mark.parametrize("num", [None, 5, 40])
def test_names_quals_and_sniff_match_tpufm(tmp_path, kind, num):
    rng = np.random.default_rng(len(kind))
    reads = [rng.integers(0, 4, size=int(n), dtype=np.uint8) for n in rng.integers(20, 40, size=12)]
    path = _write_reads(tmp_path / "r", reads, kind, rng)
    assert seqio.load_query_names(path, num) == jax_fasta.load_query_names(path, num)
    assert seqio.load_query_quals(path, num) == jax_fasta.load_query_quals(path, num)
    assert seqio.sniff_reads(path) == jax_fasta.sniff_reads(path)
    ours, theirs = seqio.load_query_names_packed(path, num), jax_fasta.load_query_names_packed(path, num)
    assert ours.buf == theirs.buf and np.array_equal(ours.off, theirs.off) and list(ours) == list(theirs)
    ours, theirs = seqio.load_query_quals_packed(path, num), jax_fasta.load_query_quals_packed(path, num)
    assert (ours is None) == (theirs is None) == kind.startswith("fasta")
    if ours is not None:
        assert ours.buf == theirs.buf and np.array_equal(ours.off, theirs.off)
        assert [ours[i] for i in range(len(ours))] == list(theirs)


@pytest.mark.parametrize("data", [b"", b">only a header\n", b"@r\n\n+\n\n", b"ACGT\r\nAC", b">a\nACG\n\n>b\nT"])
def test_sniff_reads_edge_files_match_tpufm(tmp_path, data):
    path = tmp_path / "r.fa"
    path.write_bytes(data)
    assert seqio.sniff_reads(path) == jax_fasta.sniff_reads(path)


@pytest.mark.parametrize("gz", [False, True])
def test_fasta_num_bases_matches_tpufm(genome, tmp_path, gz):
    codes, fa = genome
    path = _fasta(tmp_path / "g.fa", [codes[:1000], codes[1000:1001], codes[1001:3000]], gz=gz)
    assert seqio.fasta_num_bases(path) == jax_cli._fasta_num_bases(path) == 3000


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reverse_complement_varlen_matches_tpufm(seed):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 30, size=40)
    batch = np.full((40, 30), 0xFF, np.uint8)
    for i, n in enumerate(lens):
        batch[i, 30 - n:] = rng.integers(0, 4, size=n)
    got = seqio.reverse_complement_varlen(batch)
    assert np.array_equal(got, jax_rc_varlen(batch))
    assert np.array_equal(seqio.reverse_complement_varlen(got), batch)


@pytest.mark.parametrize("refsize", [None, 1500, 1501, 2399, 2400, 4000, 5200])
@pytest.mark.parametrize("gz", [False, True])
def test_read_contigs_matches_tpufm(genome, tmp_path, refsize, gz):
    codes, fa = genome
    path = _fasta(tmp_path / "g.fa", [codes[:1500], codes[:0], codes[1500:2400], codes[2400:]], gz=gz)
    ours, theirs = contigs.read_contigs(path, refsize), jax_contigs.read_contigs(path, refsize)
    assert ours.names == theirs.names and ours.total == theirs.total
    assert np.array_equal(ours.starts, theirs.starts) and ours.starts.dtype == theirs.starts.dtype


def test_read_contigs_headers_match_tpufm(tmp_path):
    recs = [np.zeros(5, np.uint8), np.ones(7, np.uint8), np.full(3, 2, np.uint8)]
    path = _fasta(tmp_path / "g.fa", recs, headers=[b"> 5", b">", b">chrX y"])
    ours, theirs = contigs.read_contigs(path), jax_contigs.read_contigs(path)
    assert ours.names == theirs.names == ["5", "seq1", "chrX"]
    bad = tmp_path / "bad.fa"
    bad.write_bytes(b"ACGT\n")
    with pytest.raises(ValueError, match="not a FASTA"):
        contigs.read_contigs(bad)


@pytest.mark.parametrize("query_len", [None, 1, 30, "per-row"])
def test_contig_map_resolve_and_format_match_tpufm(genome, query_len):
    codes, fa = genome
    ours, theirs = contigs.read_contigs(fa), jax_contigs.read_contigs(fa)
    rng = np.random.default_rng(3)
    pos = rng.integers(0, codes.shape[0], size=(64, 5)).astype(np.uint32)
    pos[::3, 2] = 0xFFFFFFFF
    pos[1, :] = [1499, 1500, 2399, 2400, 5199]  # at and around each record's end
    ql = rng.integers(1, 50, size=(64, 1)) if query_len == "per-row" else query_len
    for a, b in zip(ours.resolve(pos, ql), theirs.resolve(pos, ql)):
        assert np.array_equal(a, b) and a.dtype == b.dtype
    assert ours.format(pos, ql) == theirs.format(pos, ql)


def _edit_reads(codes, rng, L, E, n, near_end):
    """Reads of length L within E edits of the text (exact, edited,
    shifted by a base so that the best path starts with a deletion, and
    random), at starts anywhere or in the last L + E bases."""
    reads, starts = [], []
    for t in range(n):
        s = int(rng.integers(codes.shape[0] - L - E, codes.shape[0])) if near_end else int(rng.integers(0, 400))
        w = list(codes[s:s + L + E]) + [0] * (L + E)
        kind = t % 4
        if kind == 1:
            for _ in range(E):
                p = int(rng.integers(0, L))
                op = rng.integers(0, 3)
                if op == 0:
                    w[p] = (w[p] + 1) & 3
                elif op == 1:
                    del w[p]
                else:
                    w.insert(p, int(rng.integers(0, 4)))
        elif kind == 2:
            w = w[1:]
        elif kind == 3:
            w = list(rng.integers(0, 4, size=L))
        reads.append(np.array(w[:L], np.uint8))
        starts.append(s)
    return np.stack(reads), np.asarray(starts)


@pytest.mark.parametrize("E", [1, 2, 3])
@pytest.mark.parametrize("near_end", [False, True], ids=["inside", "text-end"])
@pytest.mark.parametrize("L", [12, 31])
def test_edit_alignments_match_tpufm(genome, E, near_end, L):
    codes, _ = genome
    rng = np.random.default_rng(E * 10 + L + near_end)
    reads, starts = _edit_reads(codes, rng, L, E, 48, near_end)
    ours = edit_alignments(codes, reads, starts, E)
    theirs = jax_edit_alignments(codes, reads, starts, E)
    assert ours[0] == theirs[0]
    for a, b in zip(ours[1:], theirs[1:]):
        assert np.array_equal(a, b) and a.dtype == b.dtype
    if not near_end:  # the shifted reads begin with a deletion
        assert any(c.startswith("1D") for c in ours[0][2::4])
    empty = edit_alignments(codes, reads[:0], starts[:0], E)
    assert empty[0] == [] and empty[1].shape == empty[2].shape == (0,)


@pytest.mark.parametrize("extra", ["", "tpufm align"])
def test_sam_header_matches_tpufm(genome, extra):
    _, fa = genome
    cmap = contigs.read_contigs(fa)
    assert sam.sam_header(cmap, extra) == jax_sam.sam_header(jax_contigs.read_contigs(fa), extra)


def _positions(codes, reads, rng, H, varlen_lengths=None):
    """Sentinel-padded [B, H] positions of reads and of their reverse
    complements: the true site of most reads (on the strand it came from),
    plus random and record-crossing positions, some rows empty."""
    B = reads.shape[0]
    pos = np.full((2 * B, H), 0xFFFFFFFF, np.uint32)
    n = codes.shape[0]
    for i in range(2 * B):
        k = int(rng.integers(0, H + 1)) if i % 7 else 0
        pos[i, :k] = np.sort(rng.choice(n - 10, size=k, replace=False))
    pos[1, 0] = 1495  # a match across chr1's end: dropped
    return pos


@pytest.fixture(scope="module")
def single(genome):
    codes, fa = genome
    rng = np.random.default_rng(9)
    B, L = 48, 30
    starts = rng.integers(0, codes.shape[0] - L, size=B)
    reads = codes[starts[:, None] + np.arange(L)]
    reads[::4, 3] = (reads[::4, 3] + 1) % 4
    names = [f"q{i}" for i in range(B)]
    quals = [_phred(rng, L) if i % 5 else (None if i % 2 else "") for i in range(B)]
    return codes, fa, reads, names, quals, rng


@pytest.mark.parametrize("H", [1, 4, 300], ids=["H1", "H4", "H300"])
@pytest.mark.parametrize("with_codes", [False, True], ids=["exact", "hamming"])
@pytest.mark.parametrize("with_quals", [False, True], ids=["no-qual", "qual"])
@pytest.mark.parametrize("emitter", ["native", "python"])
@pytest.mark.parametrize("return_blocks", [False, True], ids=["text", "blocks"])
def test_sam_single_records_match_tpufm(single, monkeypatch, H, with_codes, with_quals, emitter, return_blocks):
    """Both emitters, byte-equal to tpufm's writer (with its native emitter;
    H=300 puts 2H past the 512-site buffer, so both take the Python loop)."""
    codes, fa, reads, names, quals, rng = single
    B = reads.shape[0]
    pos = _positions(codes, reads, np.random.default_rng(H), H)
    cmap_j = jax_contigs.read_contigs(fa)
    kw = dict(codes=codes if with_codes else None, quals=quals if with_quals else None,
              return_blocks=return_blocks)
    want = jax_sam.sam_single_records(names, reads, pos[:B], pos[B:], cmap_j, **kw)
    got = sam.sam_single_records(names, reads, pos[:B], pos[B:], contigs.read_contigs(fa), emitter=emitter, **kw)
    assert got == want
    assert ("NM:i:1" in str(got)) == with_codes


def test_sam_single_records_packed_inputs_and_varlen(genome, tmp_path):
    """PackedStrs names and qualities, right-aligned mixed-length reads with
    each read's own length: the same text as tpufm's on the same inputs."""
    codes, fa = genome
    rng = np.random.default_rng(17)
    lens = rng.choice([20, 27, 33], size=40)
    starts = rng.integers(0, codes.shape[0] - 40, size=40)
    batch = np.full((40, 33), 0xFF, np.uint8)
    for i, (s, n) in enumerate(zip(starts, lens)):
        batch[i, 33 - n:] = codes[s:s + n]
    path = tmp_path / "v.fq"
    path.write_text("".join(f"@v{i}\n{seqio.decode_bases(batch[i, 33 - n:]).decode()}\n+\n{_phred(rng, n)}\n"
                            for i, n in enumerate(lens)))
    pos = _positions(codes, batch, rng, 5)
    pos[:40, 0] = starts
    names, quals = seqio.load_query_names_packed(path), seqio.load_query_quals_packed(path)
    jn, jq = jax_fasta.load_query_names_packed(path), jax_fasta.load_query_quals_packed(path)
    cmap, cmap_j = contigs.read_contigs(fa), jax_contigs.read_contigs(fa)
    want = jax_sam.sam_single_records(jn, batch, pos[:40], pos[40:], cmap_j, codes=codes, lengths=lens, quals=jq)
    for emitter in ("native", "python"):
        got = sam.sam_single_records(names, batch, pos[:40], pos[40:], cmap, codes=codes, lengths=lens,
                                     quals=quals, emitter=emitter)
        assert got == want
    assert want.count("\tNM:i:0") >= 30


def test_sam_single_records_refuses_an_unknown_emitter(single):
    codes, fa, reads, names, _, _ = single
    pos = np.full((reads.shape[0], 2), 0xFFFFFFFF, np.uint32)
    with pytest.raises(ValueError, match="emitter"):
        sam.sam_single_records(names, reads, pos, pos, contigs.read_contigs(fa), emitter="fast")


def test_native_emitter_equals_the_python_loop_on_many_reads(genome):
    """The native emitter against its plain version on 2,000 reads of mixed
    site counts, with and without qualities."""
    codes, fa = genome
    rng = np.random.default_rng(23)
    B, L = 2000, 25
    reads = codes[rng.integers(0, codes.shape[0] - L, size=B)[:, None] + np.arange(L)]
    pos = _positions(codes, reads, rng, 6)
    cmap = contigs.read_contigs(fa)
    quals = seqio.PackedStrs.join(_phred(rng, L) if i % 3 else "" for i in range(B))
    for q in (None, quals):
        native = sam.sam_single_records([f"n{i}" for i in range(B)], reads, pos[:B], pos[B:], cmap, codes=codes,
                                        quals=q, emitter="native")
        assert native == sam.sam_single_records([f"n{i}" for i in range(B)], reads, pos[:B], pos[B:], cmap,
                                                codes=codes, quals=q, emitter="python")
    assert native.count("\n") > B


@pytest.mark.parametrize("E", [1, 2])
@pytest.mark.parametrize("with_quals", [False, True], ids=["no-qual", "qual"])
@pytest.mark.parametrize("return_blocks", [False, True], ids=["text", "blocks"])
def test_sam_edit_records_match_tpufm(single, E, with_quals, return_blocks):
    codes, fa, reads, names, quals, _ = single
    B = reads.shape[0]
    pos = _positions(codes, reads, np.random.default_rng(E), 4)
    pos[B - 1, 0] = codes.shape[0] - 10  # an alignment past the text's end
    kw = dict(quals=quals if with_quals else None, return_blocks=return_blocks)
    want = jax_sam.sam_edit_records(names, reads, pos[:B], pos[B:], jax_contigs.read_contigs(fa), codes, E, **kw)
    assert sam.sam_edit_records(names, reads, pos[:B], pos[B:], contigs.read_contigs(fa), codes, E, **kw) == want
    empty = np.full((B, 4), 0xFFFFFFFF, np.uint32)
    assert sam.sam_edit_records(names, reads, empty, empty, contigs.read_contigs(fa), codes, E) == \
        jax_sam.sam_edit_records(names, reads, empty, empty, jax_contigs.read_contigs(fa), codes, E)


def _pairs(codes, rng, B, P, L1, L2):
    """PairedEndEngine-shaped (pairs, strand): true FR pairs, random ones,
    pairs across records and padding."""
    n = codes.shape[0]
    left = rng.integers(0, n - 400, size=(B, P))
    right = left + rng.integers(100, 300, size=(B, P))
    pairs = np.stack([left, right], axis=-1).astype(np.uint32)
    strand = rng.integers(0, 2, size=(B, P)).astype(np.uint8)
    fill = rng.integers(0, P + 1, size=B)
    pad = np.arange(P)[None, :] >= fill[:, None]
    pairs[pad] = 0xFFFFFFFF
    strand[pad] = 2
    pairs[0, 0] = (1400, 1600)  # across chr1's end
    strand[0, 0] = 0
    return pairs, strand


@pytest.mark.parametrize("mode", ["exact", "hamming", "edits1", "edits2"])
@pytest.mark.parametrize("lengths", [(30, 30), (30, 24)], ids=["L1=L2", "L1!=L2"])
@pytest.mark.parametrize("with_quals", [False, True], ids=["no-qual", "qual"])
def test_sam_paired_records_match_tpufm(genome, mode, lengths, with_quals):
    codes, fa = genome
    rng = np.random.default_rng(len(mode) + lengths[1])
    B, P = 24, 3
    L1, L2 = lengths
    r1 = rng.integers(0, 4, size=(B, L1), dtype=np.uint8)
    r2 = rng.integers(0, 4, size=(B, L2), dtype=np.uint8)
    pairs, strand = _pairs(codes, rng, B, P, L1, L2)
    for i in range(B):  # make the first pair of each read real where it is plus
        a, b = int(pairs[i, 0, 0]), int(pairs[i, 0, 1])
        if a != 0xFFFFFFFF and strand[i, 0] == 0:
            r1[i] = codes[a:a + L1]
            r2[i] = seqio.reverse_complement(codes[b:b + L2])
    names = [f"p{i}" for i in range(B)]
    q1 = [_phred(rng, L1) for _ in range(B)] if with_quals else None
    q2 = [_phred(rng, L2) if i % 4 else None for i in range(B)] if with_quals else None
    kw = dict(codes=None if mode == "exact" else codes, edits=int(mode[-1]) if mode.startswith("edits") else 0,
              quals1=q1, quals2=q2)
    for blocks in (True, False):
        want = jax_sam.sam_paired_records(names, r1, r2, pairs, strand, jax_contigs.read_contigs(fa),
                                          return_blocks=blocks, **kw)
        got = sam.sam_paired_records(names, r1, r2, pairs, strand, contigs.read_contigs(fa),
                                     return_blocks=blocks, **kw)
        assert got == want
    assert "\t77\t" in want and "\t=\t" in want
