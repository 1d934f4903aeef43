"""The port's variable-length search (SearchEngine.search_varlen) and reader
(load_queries_varlen) against the JAX package's: XLAEngine.search_varlen,
the per-read fixed-length oracle (search_oracle with the k=1 tail, once per
read) and tpufm.io.fasta.load_queries_varlen. The cases are those of
tests/test_varlen.py. Inputs are made with numpy from a seed and handed to
both sides; intervals and codes are integers and compare exactly
(tolerance 0)."""

import gzip

import numpy as np
import pytest

from tpufm.config import IndexConfig
from tpufm.engine.oracle import search_oracle
from tpufm.engine.xla import VARLEN_PAD, XLAEngine
from tpufm.index.builder import build_index, derive_tail
from tpufm.io.fasta import load_queries_varlen as jax_load_varlen
from tpufm.utils.encoding import decode_bases
from tpufm_torch import SearchEngine, tables_from_jax
from tpufm_torch.engine.lf_round import lf_round_reference
from tpufm_torch.host import seqio


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(42)
    codes = rng.integers(0, 4, size=50_000, dtype=np.uint8)
    index = build_index(codes, IndexConfig(k=3, d=64))
    return codes, index, derive_tail(index)


def _mixed_batch(codes, rng, lengths):
    """Right-aligned VARLEN_PAD-padded batch: even rows sampled from the
    text (hits), odd rows uniform random (mostly misses)."""
    lmax = max(lengths)
    batch = np.full((len(lengths), lmax), VARLEN_PAD, dtype=np.uint8)
    true = []
    for i, L in enumerate(lengths):
        if i % 2 == 0:
            s = int(rng.integers(0, len(codes) - L))
            read = codes[s : s + L]
        else:
            read = rng.integers(0, 4, size=L, dtype=np.uint8)
        true.append(read)
        batch[i, lmax - L :] = read
    return batch, true


def _oracle_per_read(index, tail, true_reads):
    return np.stack([search_oracle(index, r[None, :], tail_index=tail)[0] for r in true_reads])


@pytest.mark.parametrize("gather", ["fused", "dma"])
def test_varlen_matches_xla_and_per_read_oracle(setup, rng, gather):
    codes, index, tail = setup
    lengths = [15, 16, 17, 18, 30, 31, 45, 44, 29, 15, 33, 46]
    batch, true = _mixed_batch(codes, rng, lengths)
    want = XLAEngine(index, tail_index=tail, gather="xla" if gather == "fused" else "dma").search_varlen(batch)
    np.testing.assert_array_equal(want, _oracle_per_read(index, tail, true))
    engine = SearchEngine(index, "cpu", tail_index=tail, gather=gather)
    np.testing.assert_array_equal(engine.search_varlen(batch), want)
    np.testing.assert_array_equal(engine.search_varlen(batch, step=lf_round_reference), want)


@pytest.fixture(scope="module")
def lut12(setup):
    """The JAX engine with a 12-mer LUT, whose tables (LUT included) the port
    takes over instead of building 4^12 rows again on the CPU."""
    _, index, tail = setup
    return XLAEngine(index, tail_index=tail, lut_m=12)


@pytest.mark.parametrize("gather", ["fused", "dma"])
def test_varlen_with_lut(setup, lut12, rng, gather):
    codes, index, tail = setup
    lengths = [12, 13, 14, 20, 27, 12, 35, 40]  # min == lut_m exactly
    batch, true = _mixed_batch(codes, rng, lengths)
    want = lut12.search_varlen(batch)
    np.testing.assert_array_equal(want, _oracle_per_read(index, tail, true))
    engine = SearchEngine(tables_from_jax(lut12.tables), "cpu", gather=gather)
    assert engine.lut_m == 12
    np.testing.assert_array_equal(engine.search_varlen(batch), want)


def test_varlen_uniform_equals_fixed(setup, rng):
    # a varlen batch that happens to be uniform must equal the fixed path
    codes, index, tail = setup
    reads = rng.integers(0, 4, size=(32, 24), dtype=np.uint8)
    engine = SearchEngine(index, "cpu", tail_index=tail)
    got = engine.search_varlen(reads)
    np.testing.assert_array_equal(got, engine.search(reads))
    np.testing.assert_array_equal(got, XLAEngine(index, tail_index=tail).search_varlen(reads))


@pytest.mark.parametrize("k", [1, 2])
def test_varlen_small_k(setup, rng, k):
    codes, _, _ = setup
    index = build_index(codes, IndexConfig(k=k, d=32))
    tail = None if k == 1 else derive_tail(index)
    lengths = [7, 9, 10, 23, 8, 31]
    batch, true = _mixed_batch(codes, rng, lengths)
    want = XLAEngine(index, tail_index=tail).search_varlen(batch)
    np.testing.assert_array_equal(want, _oracle_per_read(index, tail, true))
    got = SearchEngine(index, "cpu", tail_index=tail).search_varlen(batch)
    np.testing.assert_array_equal(got, want)


def test_varlen_waves(setup, rng):
    codes, index, tail = setup
    lengths = [15 + int(x) for x in rng.integers(0, 30, size=100)]
    batch, true = _mixed_batch(codes, rng, lengths)
    engine = SearchEngine(index, "cpu", tail_index=tail, lut_m=6)
    got = engine.search_varlen(batch, wave=32)
    np.testing.assert_array_equal(got, engine.search_varlen(batch))
    np.testing.assert_array_equal(
        got, XLAEngine(index, tail_index=tail, lut_m=6).search_varlen(batch, wave=32)
    )


def test_varlen_validation(setup, lut12, rng):
    codes, index, tail = setup
    batch = np.full((4, 20), VARLEN_PAD, dtype=np.uint8)
    batch[:, 10:] = rng.integers(0, 4, size=(4, 10), dtype=np.uint8)
    cases = [
        (XLAEngine(index), SearchEngine(index, "cpu"), batch, "tail_index"),
        (lut12, SearchEngine(tables_from_jax(lut12.tables), "cpu"), batch, "lut_m=12"),
        (XLAEngine(index, tail_index=tail), SearchEngine(index, "cpu", tail_index=tail),
         np.full((1, 8), VARLEN_PAD, dtype=np.uint8), "empty read"),
    ]
    for jax_engine, engine, queries, match in cases:
        with pytest.raises(ValueError, match=match) as jax_err:
            jax_engine.search_varlen(queries)
        with pytest.raises(ValueError, match=match) as err:
            engine.search_varlen(queries)
        assert str(err.value) == str(jax_err.value)


def _write_reads(path, reads, fmt):
    lines = []
    for i, r in enumerate(reads):
        seq = decode_bases(r).decode()
        lines += [f"@r{i}", seq, "+", "I" * len(seq)] if fmt == "fastq" else [f">r{i}", seq, ""]
    data = ("\n".join(lines) + "\n").encode()
    with open(path, "wb") as fp:
        fp.write(gzip.compress(data) if path.suffix == ".gz" else data)


@pytest.mark.parametrize("name", ["mixed.fa", "mixed.fastq", "mixed.fa.gz", "mixed.fastq.gz"])
def test_load_queries_varlen_matches_tpufm(tmp_path, setup, rng, name):
    codes, index, tail = setup
    lengths = [18, 25, 40, 19, 33, 151, 50]
    reads = [rng.integers(0, 4, size=L, dtype=np.uint8) for L in lengths]
    reads[1] = codes[100 : 100 + 25]  # one guaranteed hit
    path = tmp_path / name
    _write_reads(path, reads, "fastq" if "fastq" in name else "fasta")
    want = jax_load_varlen(path)
    got = seqio.load_queries_varlen(path)
    assert got.dtype == want.dtype and got.shape == want.shape == (7, 151)
    assert got.tobytes() == want.tobytes()
    np.testing.assert_array_equal(seqio.load_queries_varlen(path, 3), jax_load_varlen(path, 3))
    res = SearchEngine(index, "cpu", tail_index=tail).search_varlen(got)
    np.testing.assert_array_equal(res, _oracle_per_read(index, tail, reads))
    assert res[1, 1] > res[1, 0]
    for n, match in [(8, "only 7 reads, need 8")]:
        with pytest.raises(ValueError, match=match):
            seqio.load_queries_varlen(path, n)
        with pytest.raises(ValueError, match=match):
            jax_load_varlen(path, n)


def test_load_queries_varlen_no_reads(tmp_path):
    path = tmp_path / "empty.fa"
    path.write_bytes(b">only a header\n\n")
    with pytest.raises(ValueError, match="no reads found") as jax_err:
        jax_load_varlen(path)
    with pytest.raises(ValueError, match="no reads found") as err:
        seqio.load_queries_varlen(path)
    assert str(err.value) == str(jax_err.value)
    assert seqio.VARLEN_PAD == VARLEN_PAD
