"""The port's host side (tpufm_torch.host) against tpufm's: suffix arrays,
index construction and the k=1 tail, index files in every layout, reads and
results on disk, and the numpy oracle. Inputs are made with numpy from a
seed and handed to both; arrays are integers and files are bytes, and both
compare exactly (tolerance 0)."""

import dataclasses
import gzip

import numpy as np
import pytest

from tpufm.config import IndexConfig as JaxIndexConfig
from tpufm.config import Layout as JaxLayout
from tpufm.engine.oracle import search_oracle as jax_oracle
from tpufm.index import builder as jb
from tpufm.index import formats as jf
from tpufm.index import store as jstore
from tpufm.index import locate as jlocate
from tpufm.index.layouts import make_alt_counters
from tpufm.index.suffix_array import suffix_array_doubling
from tpufm.io import fasta as jfasta
from tpufm.io import genreads as jgen
from tpufm.io.results import write_results as jax_write_results
from tpufm.utils import encoding as jenc
from tpufm_torch.host import formats, index as host, locate as host_locate, oracle, seqio
from tpufm_torch.host.suffix_array import suffix_array

_ARRAYS = ("occ", "bitmaps", "dollar_pos", "dollar_base")


def _texts():
    rng = np.random.default_rng(99)
    return {
        "random": rng.integers(0, 4, size=777, dtype=np.uint8),
        "one_base": np.zeros(300, dtype=np.uint8),
        "periodic": np.tile(np.asarray([0, 1, 0, 2], np.uint8), 90),
        "short": np.asarray([3, 1], np.uint8),
    }


def _assert_index_equal(ours, theirs):
    assert (ours.config.k, ours.config.d, ours.bwtsize) == (
        theirs.config.k, theirs.config.d, theirs.bwtsize,
    )
    assert ours.config.layout.value == theirs.config.layout.value
    for name in _ARRAYS:
        a, b = np.asarray(getattr(ours, name)), np.asarray(getattr(theirs, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("text", sorted(_texts()))
@pytest.mark.parametrize("method", ["native", "doubling"])
def test_suffix_array_matches_tpufm(text, method):
    codes = _texts()[text]
    np.testing.assert_array_equal(suffix_array(codes, method), suffix_array_doubling(codes))


def test_suffix_array_rejects_unknown_method():
    with pytest.raises(ValueError, match="unknown"):
        suffix_array(np.zeros(4, np.uint8), "naive")


# (k, d, n): n + 1 a multiple of d puts the end-of-text end on the sentinel row
@pytest.mark.parametrize(
    "k,d,n",
    [(1, 32, 500), (2, 64, 4 * 64 - 1), (3, 192, 1000), (3, 192, 5 * 192 - 1),
     (4, 32, 700), (2, 96, 64)],
)
def test_build_index_and_tail_match_tpufm(rng, k, d, n):
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    ours = host.build_index(codes, host.IndexConfig(k=k, d=d), sa_method="native")
    theirs = jb.build_index(codes, JaxIndexConfig(k=k, d=d), sa_method="doubling")
    _assert_index_equal(ours, theirs)
    _assert_index_equal(host.derive_tail(ours), jb.derive_tail(theirs))
    np.testing.assert_array_equal(ours.dollar_block, theirs.dollar_block)


def test_build_index_takes_ascii(rng):
    text = jenc.decode_bases(rng.integers(0, 4, size=200, dtype=np.uint8))
    cfg = host.IndexConfig(k=2, d=32)
    for ref in (text, text.decode(), np.frombuffer(text, np.uint8)):
        _assert_index_equal(
            host.build_index(ref, cfg, sa_method="doubling"),
            jb.build_index(text, JaxIndexConfig(k=2, d=32), sa_method="doubling"),
        )


def test_index_config_matches_tpufm():
    for k, d in [(1, 32), (3, 192), (8, 64)]:
        ours, theirs = host.IndexConfig(k=k, d=d), JaxIndexConfig(k=k, d=d)
        for attr in ("num_counters", "num_slim_counters", "words_per_plane", "bitmap_words"):
            assert getattr(ours, attr) == getattr(theirs, attr), attr
        assert ours.num_entries(1001) == theirs.num_entries(1001)
    for layout in JaxLayout:
        assert host.Layout(layout.value).fmi_tag == layout.fmi_tag
        assert host.Layout.from_fmi_tag(layout.fmi_tag).value == layout.value
    for k, d in [(0, 32), (9, 32), (2, 48)]:
        with pytest.raises(ValueError):
            host.IndexConfig(k=k, d=d)


def _pair(rng, k, d, n):
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    ours = host.build_index(codes, host.IndexConfig(k=k, d=d), sa_method="doubling")
    theirs = jb.build_index(codes, JaxIndexConfig(k=k, d=d), sa_method="doubling")
    return codes, ours, theirs


@pytest.mark.parametrize("layout", ["baseline", "interleaved"])
@pytest.mark.parametrize("n", [900, 6 * 64 - 1])
def test_write_fmi_byte_identical(rng, tmp_path, layout, n):
    _, ours, theirs = _pair(rng, 3, 64, n)
    formats.write_fmi(tmp_path / "ours.fmi", ours, host.Layout(layout))
    jf.write_fmi(tmp_path / "theirs.fmi", theirs, JaxLayout(layout))
    assert (tmp_path / "ours.fmi").read_bytes() == (tmp_path / "theirs.fmi").read_bytes()


@pytest.mark.parametrize(
    "layout", ["baseline", "interleaved", "alt_counters", "interleaved_alt_counters"]
)
@pytest.mark.parametrize(
    "k,d,n",
    # entries odd or even, last block partial or full
    [(2, 64, 900), (2, 64, 1000), (3, 64, 1000), (3, 64, 6 * 64 - 1), (1, 32, 7 * 32 - 1)],
)
def test_read_fmi_matches_tpufm(rng, tmp_path, layout, k, d, n):
    _, _, theirs = _pair(rng, k, d, n)
    path = tmp_path / "ref.fmi"
    jf.write_fmi(path, theirs, JaxLayout(layout))
    ours, our_layout = formats.read_fmi(path)
    want, want_layout = jf.read_fmi(path)
    assert our_layout.value == want_layout.value
    if layout.endswith("alt_counters"):
        np.testing.assert_array_equal(ours.occ_slim, want.occ_slim)
        ours, want = ours.base, want.base
    # the full logical index of any image is the one it was written from
    _assert_index_equal(ours, dataclasses.replace(theirs, config=want.config))


def test_write_fmi_refuses_alt_counters(rng, tmp_path):
    """write_fmi refused tags 200/201 until the port had its own
    alternate-counters writer; it now writes both, byte-identical to
    tpufm's (tests/test_torch_transform.py covers k 1-4 and every parity)."""
    _, ours, theirs = _pair(rng, 2, 64, 300)
    for layout in ("alt_counters", "interleaved_alt_counters"):
        formats.write_fmi(tmp_path / "x.fmi", ours, host.Layout(layout))
        jf.write_fmi(tmp_path / "y.fmi", theirs, JaxLayout(layout))
        assert (tmp_path / "x.fmi").read_bytes() == (tmp_path / "y.fmi").read_bytes()


def test_load_npz_matches_tpufm(rng, tmp_path):
    _, _, theirs = _pair(rng, 3, 192, 800)
    jf.save_npz(tmp_path / "ref.npz", theirs)
    _assert_index_equal(formats.load_npz(tmp_path / "ref.npz"), jf.load_npz(tmp_path / "ref.npz"))


@pytest.mark.parametrize("kind", ["kstep", "alt_counters"])
@pytest.mark.parametrize("mmap", [True, False])
def test_load_store_matches_tpufm(rng, tmp_path, kind, mmap):
    _, _, theirs = _pair(rng, 2, 64, 700)
    stored = make_alt_counters(theirs) if kind == "alt_counters" else theirs
    root = jstore.save_store(tmp_path / "ref", stored)
    ours, want = formats.load_store(root, mmap=mmap), jstore.load_store(root, mmap=mmap)
    if kind == "alt_counters":
        np.testing.assert_array_equal(ours.occ_slim, want.occ_slim)
        assert ours.config.k == 2 and ours.bwtsize == want.bwtsize
        ours, want = ours.base, want.base
    _assert_index_equal(ours, want)


def test_load_store_refuses_other_kinds(tmp_path):
    root = tmp_path / "x.tpufm"
    root.mkdir()
    (root / "meta.json").write_text('{"kind": "kstep_sharded", "format": 1}')
    with pytest.raises(ValueError, match="not a k-step index or locate tables"):
        formats.load_store(root)
    (root / "meta.json").write_text('{"kind": "kstep", "format": 2}')
    with pytest.raises(ValueError, match="newer"):
        formats.load_store(root)


def _locate_pair(rng, d, s, n):
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    sa = suffix_array_doubling(codes)
    return host_locate.build_locate(codes, s, d, sa=sa), jlocate.build_locate(codes, s, d, sa=sa)


def _assert_locate_equal(ours, theirs):
    assert ours.sample_rate == theirs.sample_rate
    _assert_index_equal(ours.lf1, theirs.lf1)
    for name in ("mark_words", "mark_rank", "samples"):
        a, b = np.asarray(getattr(ours, name)), np.asarray(getattr(theirs, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("kind", ["kstep", "locate"])
@pytest.mark.parametrize("writer", ["port", "tpufm"])
def test_stores_load_across(rng, tmp_path, kind, writer):
    """A store either package writes (kinds kstep and locate) loads in the
    other, with identical arrays, and the two write the same files."""
    if kind == "kstep":
        _, ours, theirs = _pair(rng, 2, 64, 700)
        check = _assert_index_equal
    else:
        ours, theirs = _locate_pair(rng, 64, 8, 700)
        check = _assert_locate_equal
    save, load = (formats.save_store, jstore.load_store) if writer == "port" else (jstore.save_store, formats.load_store)
    root = save(tmp_path / "x", ours if writer == "port" else theirs)
    assert root == tmp_path / "x.tpufm"
    loaded = load(root)
    check(loaded, theirs) if writer == "port" else check(ours, loaded)
    other = (jstore.save_store if writer == "port" else formats.save_store)(
        tmp_path / "y.tpufm", theirs if writer == "port" else ours)
    assert sorted(p.name for p in root.iterdir()) == sorted(p.name for p in other.iterdir())
    for f in root.iterdir():
        assert f.read_bytes() == (other / f.name).read_bytes(), f.name


@pytest.mark.parametrize("mmap", [True, False])
def test_load_locate_store_matches_tpufm(rng, tmp_path, mmap):
    ours, theirs = _locate_pair(rng, 32, 4, 6 * 32 - 1)
    root = jstore.save_store(tmp_path / "loc", theirs)
    _assert_locate_equal(formats.load_store(root, mmap=mmap), jstore.load_store(root, mmap=mmap))
    _assert_locate_equal(formats.load_store(root, mmap=mmap), ours)


def test_save_store_refuses_other_objects(rng, tmp_path):
    _, ours, _ = _pair(rng, 2, 64, 300)
    with pytest.raises(TypeError, match="kinds kstep and locate"):
        formats.save_store(tmp_path / "x", host.AltCountersIndex(base=ours, occ_slim=ours.occ))


def test_build_index_takes_its_suffix_array(rng):
    codes = rng.integers(0, 4, size=500, dtype=np.uint8)
    sa = suffix_array(codes, "doubling")
    _assert_index_equal(host.build_index(codes, host.IndexConfig(k=3, d=64), sa=sa),
                        jb.build_index(codes, JaxIndexConfig(k=3, d=64), sa=sa))
    with pytest.raises(ValueError, match="sa has 500 entries"):
        host.build_index(codes, host.IndexConfig(k=3, d=64), sa=sa[:-1])


def test_encoding_matches_tpufm(rng):
    every_byte = bytes(range(256))
    np.testing.assert_array_equal(seqio.encode_bases(every_byte), jenc.encode_bases(every_byte))
    np.testing.assert_array_equal(seqio.encode_bases("ACGTacgtN"), jenc.encode_bases("ACGTacgtN"))
    np.testing.assert_array_equal(
        seqio.encode_bases(np.frombuffer(every_byte, np.uint8)),
        jenc.encode_bases(np.frombuffer(every_byte, np.uint8)),
    )
    codes = rng.integers(0, 4, size=(5, 37), dtype=np.uint8)
    assert seqio.decode_bases(codes) == jenc.decode_bases(codes)
    np.testing.assert_array_equal(seqio.reverse_complement(codes), jenc.reverse_complement(codes))


@pytest.mark.parametrize("gz", [False, True])
def test_reference_files_match_tpufm(rng, tmp_path, gz):
    text = jenc.decode_bases(rng.integers(0, 4, size=500, dtype=np.uint8))
    seqio.write_reference(tmp_path / "ours.fa", text)
    jfasta.write_reference(tmp_path / "theirs.fa", text)
    data = (tmp_path / "theirs.fa").read_bytes()
    assert (tmp_path / "ours.fa").read_bytes() == data
    # a second record and blank lines are read across, as tpufm reads them
    data += b">second\n\nACGTTGCA\n"
    path = tmp_path / "ref.fa"
    path.write_bytes(gzip.compress(data) if gz else data)
    for size in (None, 100, 508):
        np.testing.assert_array_equal(
            seqio.read_reference(path, size), jfasta.read_reference(path, size)
        )
    with pytest.raises(ValueError, match="need"):
        seqio.read_reference(path, 10_000)


@pytest.mark.parametrize("fmt", ["qry", "fastq", "fastq.gz"])
def test_load_queries_matches_tpufm(rng, tmp_path, fmt):
    codes = rng.integers(0, 4, size=3000, dtype=np.uint8)
    reads, starts = jgen.generate_reads(codes, 30, 50, seed=4, return_starts=True)
    path = tmp_path / f"reads.{fmt}"
    if fmt == "qry":
        jgen.write_reads_fasta(path, reads, starts)
    else:
        seqs = jenc.decode_bases(reads)
        recs = b"".join(
            b"@r%d\n%s\n+\n%s\n" % (i, seqs[30 * i:30 * i + 30], b"I" * 30) for i in range(50)
        )
        path.write_bytes(gzip.compress(recs) if fmt.endswith(".gz") else recs)
    for n in (None, 1, 50):
        np.testing.assert_array_equal(
            seqio.load_queries(path, 30, n), jfasta.load_queries(path, 30, n)
        )
    with pytest.raises(ValueError, match="expected 31"):
        seqio.load_queries(path, 31)
    with pytest.raises(ValueError, match="need 51"):
        seqio.load_queries(path, 30, 51)


@pytest.mark.parametrize("with_starts", [True, False])
def test_generated_reads_and_files_match_tpufm(rng, tmp_path, with_starts):
    codes = rng.integers(0, 4, size=20_000, dtype=np.uint8)
    ours, our_starts = seqio.generate_reads(codes, 40, 300, seed=8, return_starts=True)
    theirs, their_starts = jgen.generate_reads(codes, 40, 300, seed=8, return_starts=True)
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(our_starts, their_starts)
    np.testing.assert_array_equal(seqio.generate_reads(codes, 40, 300, seed=8), theirs)
    starts = their_starts if with_starts else None
    seqio.write_reads_fasta(tmp_path / "ours.qry", ours, starts)
    jgen.write_reads_fasta(tmp_path / "theirs.qry", theirs, starts)
    assert (tmp_path / "ours.qry").read_bytes() == (tmp_path / "theirs.qry").read_bytes()
    with pytest.raises(ValueError, match="exceeds"):
        seqio.generate_reads(codes[:10], 40, 1)


def test_results_file_matches_tpufm(rng, tmp_path):
    res = rng.integers(0, 1 << 32, size=(77, 2), dtype=np.uint64).astype(np.uint32)
    seqio.write_results(tmp_path / "ours.res", res)
    jax_write_results(tmp_path / "theirs.res", res)
    assert (tmp_path / "ours.res").read_bytes() == (tmp_path / "theirs.res").read_bytes()


def _reads(rng, codes, L, hits=60, misses=20):
    starts = rng.integers(0, len(codes) - L, size=hits)
    sampled = np.stack([codes[s:s + L] for s in starts])
    return np.concatenate([sampled, rng.integers(0, 4, size=(misses, L), dtype=np.uint8)])


@pytest.mark.parametrize(
    "k,d,n,L", [(1, 32, 1200, 12), (2, 64, 1200, 24), (3, 192, 1200, 24),
                (3, 64, 6 * 64 - 1, 31), (4, 32, 900, 22)],
)
def test_oracle_matches_tpufm(rng, k, d, n, L):
    codes, ours, theirs = _pair(rng, k, d, n)
    queries = _reads(rng, codes, L)
    tail = host.derive_tail(ours) if L % k else None
    got = oracle.search_oracle(ours, queries, tail_index=tail)
    want = jax_oracle(theirs, queries, tail_index=jb.derive_tail(theirs) if L % k else None)
    assert got.dtype == np.uint32 and got.shape == (80, 2)
    np.testing.assert_array_equal(got, want)
    assert (got[:60, 1] > got[:60, 0]).all()


def test_oracle_searches_alt_counters_through_base(rng, tmp_path):
    codes, _, theirs = _pair(rng, 2, 64, 1000)
    path = tmp_path / "ac.fmi"
    jf.write_fmi(path, theirs, JaxLayout.ALT_COUNTERS)
    ac, _ = formats.read_fmi(path)
    queries = _reads(rng, codes, 24)
    np.testing.assert_array_equal(
        oracle.search_oracle(ac, queries), jax_oracle(make_alt_counters(theirs), queries)
    )
    with pytest.raises(ValueError, match="tail_index"):
        oracle.search_oracle(ac, queries[:, :23])
