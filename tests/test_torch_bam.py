"""The port's BAM writer and reader (``tpufm_torch.host.bam``) against
tpufm's (tpufm/io/bam.py) on the same SAM text: the uncompressed stream,
the bgzf members and EOF block, the deflate level from the environment, and
the round trip back to SAM fields. Bytes compare exactly (tolerance 0)."""

import zlib

import numpy as np
import pytest

from tpufm.io import bam as jax_bam
from tpufm.io import contigs as jax_contigs
from tpufm.io import sam as jax_sam
from tpufm_torch.host import bam
from tpufm_torch.host.seqio import decode_bases

EOF = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000")


@pytest.fixture(scope="module")
def sam_text(tmp_path_factory):
    """SAM text of tpufm's writers over a 3-record reference: single-end
    records with and without qualities, unmapped and secondary records,
    and paired records with negative TLENs."""
    rng = np.random.default_rng(61)
    recs = [rng.integers(0, 4, size=n, dtype=np.uint8) for n in (1200, 800, 1500)]
    fa = tmp_path_factory.mktemp("bam") / "g.fa"
    fa.write_bytes(b"".join(b">c%d\n%s\n" % (i, decode_bases(r)) for i, r in enumerate(recs)))
    codes = np.concatenate(recs)
    cmap = jax_contigs.read_contigs(fa)
    B, L = 60, 31
    starts = rng.integers(0, codes.shape[0] - L, size=B)
    reads = codes[starts[:, None] + np.arange(L)]
    pos = np.full((2 * B, 3), 0xFFFFFFFF, np.uint32)
    pos[:B:2, 0] = starts[::2]
    pos[:B:3, 1] = rng.integers(0, 3000, size=len(range(0, B, 3)))
    quals = ["".join(chr(33 + int(x)) for x in rng.integers(0, 41, size=L)) if i % 4 else None for i in range(B)]
    names = [f"r{i}" for i in range(B)]
    text = jax_sam.sam_header(cmap, "tpufm align") + jax_sam.sam_single_records(
        names, reads, pos[:B], pos[B:], cmap, codes=codes, quals=quals)
    left = rng.integers(0, 900, size=(20, 2))
    pairs = np.stack([left, left + 200], axis=-1).astype(np.uint32)
    strand = rng.integers(0, 2, size=(20, 2)).astype(np.uint8)
    r1 = rng.integers(0, 4, size=(20, L), dtype=np.uint8)
    r2 = rng.integers(0, 4, size=(20, 25), dtype=np.uint8)
    text += jax_sam.sam_paired_records([f"p{i}" for i in range(20)], r1, r2, pairs, strand, cmap)
    return text


def test_sam_to_bam_bytes_match_tpufm(sam_text):
    mine, theirs = [], []
    assert bam.sam_to_bam(sam_text, mine) == jax_bam.sam_to_bam(sam_text, theirs)
    assert mine == theirs and len(mine) == sum(1 for x in sam_text.splitlines() if not x.startswith("@"))


@pytest.mark.parametrize("level", [None, 0, 1, 6, 9])
def test_bgzf_bytes_and_members_match_tpufm(sam_text, monkeypatch, level):
    raw = bam.sam_to_bam(sam_text) * 40  # several members
    mine, theirs = [], []
    got = bam.bgzf_compress(raw, mine, level=level)
    assert got == jax_bam.bgzf_compress(raw, theirs, level=level)
    assert mine == theirs and len(mine) == -(-len(raw) // bam.BGZF_STEP) + 1
    assert got.endswith(EOF) and mine[-1] == len(got) - len(EOF)
    for i, off in enumerate(mine[:-1]):  # each member alone, with its BC size and CRC
        chunk, nxt = bam.bgzf_member_at(got, off)
        assert chunk == raw[i * bam.BGZF_STEP:(i + 1) * bam.BGZF_STEP] and nxt == mine[i + 1]
    assert bam.bgzf_decompress(got) == raw


@pytest.mark.parametrize("env,ok", [("1", True), ("9", True), ("10", False), ("fast", False)])
def test_bgzf_level_from_the_environment_as_tpufm(monkeypatch, env, ok):
    monkeypatch.setenv("TPUFM_BGZF_LEVEL", env)
    data = b"ACGT" * 5000
    if ok:
        assert bam.bgzf_compress(data) == jax_bam.bgzf_compress(data) == bam.bgzf_compress(data, level=int(env))
    else:
        with pytest.raises(ValueError, match="TPUFM_BGZF_LEVEL") as mine:
            bam.bgzf_compress(data)
        with pytest.raises(ValueError) as theirs:
            jax_bam.bgzf_compress(data)
        assert str(mine.value) == str(theirs.value)


def test_bgzf_empty_and_corrupt():
    assert bam.bgzf_compress(b"") == jax_bam.bgzf_compress(b"")
    assert bam.bgzf_decompress(bam.bgzf_compress(b"")) == b""
    good = bytearray(bam.bgzf_compress(b"hello world" * 10))
    good[-len(EOF) - 8] ^= 1  # the first member's CRC
    with pytest.raises(ValueError, match="CRC"):
        bam.bgzf_decompress(bytes(good))
    with pytest.raises(ValueError, match="not a bgzf member"):
        bam.bgzf_member_at(b"\x1f\x8b\x08\x00" + bytes(30), 0)


@pytest.mark.parametrize("beg,end", [(0, 1), (16383, 16385), (0, 1 << 17), (1 << 20, (1 << 20) + 5),
                                     (5, 1 << 26), (3, 1 << 29)])
def test_reg2bin_matches_tpufm(beg, end):
    assert bam.reg2bin(beg, end) == jax_bam.reg2bin(beg, end)


@pytest.mark.parametrize("tag", ["NM:i:3", "NM:i:-7", "XA:A:q", "XF:f:1.5", "RG:Z:grp one", "XH:H:1AE3",
                                 "XB:B:c,-1,2", "XS:B:S,1,65000", "XI:B:i,5", "XN:B:f,0.5,2"])
def test_tags_encode_and_decode_as_tpufm(tag):
    enc = bam._encode_tag(tag)
    assert enc == jax_bam._encode_tag(tag)
    assert bam._decode_tags(enc) == jax_bam._decode_tags(enc)


def test_write_and_read_bam_round_trip(sam_text, tmp_path):
    """write_bam's file equals tpufm's; read_bam gives back the SAM header
    and every record's fields, and tpufm's reader reads the port's file."""
    ours, theirs = tmp_path / "a.bam", tmp_path / "b.bam"
    bam.write_bam(ours, sam_text)
    jax_bam.write_bam(theirs, sam_text)
    assert ours.read_bytes() == theirs.read_bytes()
    header, records = bam.read_bam(ours)
    lines = sam_text.splitlines()
    assert header.splitlines() == [x for x in lines if x.startswith("@")]
    assert ["\t".join(r) for r in records] == [x for x in lines if not x.startswith("@")]
    assert (header, records) == jax_bam.read_bam(ours)


def test_bam_refuses_a_qual_of_another_length():
    text = "@HD\tVN:1.6\n@SQ\tSN:c\tLN:10\nr\t0\tc\t1\t60\t4M\t*\t0\t0\tACGT\tIII\n"
    with pytest.raises(ValueError, match="QUAL length"):
        bam.sam_to_bam(text)
    bad = bytearray(zlib.compress(b"x"))
    with pytest.raises(ValueError):
        bam.bgzf_decompress(bytes(bad))
