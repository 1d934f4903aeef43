"""An alternate-counters index (tags 200/201, ``make_alt_counters``) in the
port's engines against tpufm's on the CPU: ``SearchEngine`` searches it on
its slim counters (``lf_round_ac``), as ``XLAEngine`` does, and takes or
refuses every combination as ``XLAEngine`` does, with the same ValueError
text; so do the engines whose search is the fused layout's
(``SearchLocateEngine``, ``SeedExtendEngine``, ``EditExtendEngine``) and
``search`` of an ``.ac`` image through the CLI. Intervals are integers and
compare exactly (tolerance 0)."""

import numpy as np
import pytest

from tpufm import cli as jax_cli
from tpufm.config import IndexConfig as JaxIndexConfig
from tpufm.engine.edit import EditExtendEngine as JaxEditExtendEngine
from tpufm.engine.oracle import search_oracle
from tpufm.engine.seed import SeedExtendEngine as JaxSeedExtendEngine
from tpufm.engine.xla import SearchLocateEngine as JaxSearchLocateEngine
from tpufm.engine.xla import XLAEngine
from tpufm.index import formats as jax_formats
from tpufm.index.builder import build_index as jax_build_index
from tpufm.index.builder import derive_tail as jax_derive_tail
from tpufm.index.layouts import make_alt_counters as jax_make_alt_counters
from tpufm.index.locate import build_locate as jax_build_locate
from tpufm.io.fasta import write_reference
from tpufm.io.genreads import generate_reads, write_reads_fasta
from tpufm.utils.encoding import decode_bases
from tpufm_torch import SearchEngine, SearchLocateEngine
from tpufm_torch import cli as torch_cli
from tpufm_torch.engine.edit import EditExtendEngine
from tpufm_torch.engine.seed import SeedExtendEngine
from tpufm_torch.host import formats
from tpufm_torch.host.index import IndexConfig, build_index
from tpufm_torch.host.layouts import make_alt_counters
from tpufm_torch.host.locate import build_locate


def _text(k, d, n, seed=7):
    codes = np.random.default_rng(seed).integers(0, 4, size=n, dtype=np.uint8)
    return codes, jax_build_index(codes, JaxIndexConfig(k=k, d=d), sa_method="doubling")


def _reads(codes, L, n=96, seed=3):
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, codes.shape[0] - L, size=n)
    q = codes[starts[:, None] + np.arange(L)]
    q[::6] = rng.integers(0, 4, size=q[::6].shape, dtype=np.uint8)  # mostly absent
    return q


def test_alt_counters_with_lut_raises_tpufm_text():
    """The repair: the port searched an alternate-counters index through its
    base, so it took a LUT that XLAEngine refuses."""
    codes, index = _text(2, 64, 2000)
    ac = jax_make_alt_counters(index)
    with pytest.raises(ValueError) as want:
        XLAEngine(ac, lut_m=4)
    with pytest.raises(ValueError) as got:
        SearchEngine(ac, "cpu", lut_m=4)
    assert str(got.value) == str(want.value) == "lut_m is not supported with alt-counters"


@pytest.mark.parametrize(
    "kw",
    [{"lut_m": 4}, {"tail_index": "tail"}, {"layout": "fused"}, {"layout": "paired"},
     {"layout": "paired", "lut_m": 4}, {"gather": "dma"}, {"layout": "tiled"}],
    ids=["lut", "tail", "fused", "paired", "paired-lut", "dma", "unknown"],
)
def test_alt_counters_refusals_equal_tpufm(kw):
    codes, index = _text(2, 64, 2000)
    ac = jax_make_alt_counters(index)
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("tail_index"):
        jkw["tail_index"] = tkw["tail_index"] = jax_derive_tail(index)
    if kw.get("gather"):
        jkw["gather"] = "dma"
    with pytest.raises(ValueError) as want:
        XLAEngine(ac, **jkw)
    with pytest.raises(ValueError) as got:
        SearchEngine(ac, "cpu", **tkw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("k,d,n", [(1, 64, 1500), (2, 64, 2000), (3, 128, 2500), (4, 64, 2000)])
def test_alt_counters_search_equals_xla(k, d, n):
    codes, index = _text(k, d, n, seed=k)
    ac = jax_make_alt_counters(index)
    L = 24
    q = _reads(codes, L)
    want = XLAEngine(ac).search(q)
    np.testing.assert_array_equal(want, search_oracle(index, q))
    eng = SearchEngine(ac, "cpu")
    assert eng.layout == "split" and eng.alt_counters and eng.entries is None
    np.testing.assert_array_equal(eng.search(q, wave=40), want)
    # the port's own alternate counters: the same table, the same intervals
    ours = build_index(codes, IndexConfig(k=k, d=d), sa_method="doubling")
    np.testing.assert_array_equal(make_alt_counters(ours).occ_slim, ac.occ_slim)
    np.testing.assert_array_equal(SearchEngine(make_alt_counters(ours), "cpu").search(q), want)
    if k > 1:  # a length k does not divide
        with pytest.raises(ValueError) as jerr:
            XLAEngine(ac).search(q[:, 1:])
        with pytest.raises(ValueError) as terr:
            eng.search(q[:, 1:])
        assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("layout", ["alt_counters", "interleaved_alt_counters"])
@pytest.mark.parametrize(
    "k,d,n",
    # entries even or odd, the last block partial or full (n + 1 a multiple of d)
    [(2, 64, 1000), (2, 64, 900), (3, 64, 6 * 64 - 1), (1, 32, 7 * 32 - 1)],
)
def test_alt_counters_fmi_search(tmp_path, layout, k, d, n):
    """A tag-200/201 image: the port's reader and tpufm's give the same slim
    counters, and both engines' alternate-counters searches the oracle's
    intervals. (tpufm's reader gets the logical ``base`` wrong for an even
    entry count and a partial last block, ROADMAP Queue 3; its searches
    read ``occ_slim`` and are right, so the intervals are held to the
    oracle on the image's own slim counters.)"""
    codes, index = _text(k, d, n, seed=n)
    path = tmp_path / "ref.fmi"
    jax_formats.write_fmi(path, index, jax_formats.Layout(layout))
    theirs, _ = jax_formats.read_fmi(path)
    ours, _ = formats.read_fmi(path)
    np.testing.assert_array_equal(ours.occ_slim, theirs.occ_slim)
    q = _reads(codes, 12 * k, n=64)
    want = search_oracle(theirs, q)
    np.testing.assert_array_equal(want, search_oracle(index, q))
    np.testing.assert_array_equal(SearchEngine(ours, "cpu").search(q), want)
    np.testing.assert_array_equal(XLAEngine(theirs).search(q), want)


def test_fused_only_engines_refuse_alt_counters_as_tpufm():
    """SearchLocateEngine, SeedExtendEngine and EditExtendEngine build the
    fused layout's search (XLAEngine(layout="fused") in tpufm): on an
    alternate-counters index they raise tpufm's ValueError, with a LUT its
    LUT text, else the layout text."""
    codes, index = _text(2, 64, 1500)
    ac = jax_make_alt_counters(index)
    loc = jax_build_locate(codes, sample_rate=8, d=64)
    ours = build_index(codes, IndexConfig(k=2, d=64), sa_method="doubling")
    our_ac = make_alt_counters(ours)
    our_loc = build_locate(codes, sample_rate=8, d=64)
    pairs = [
        (lambda lut: JaxSearchLocateEngine(ac, loc, lut_m=lut),
         lambda lut: SearchLocateEngine(our_ac, our_loc, "cpu", lut_m=lut)),
        (lambda lut: JaxSeedExtendEngine(ac, loc, codes, mismatches=2, lut_m=lut),
         lambda lut: SeedExtendEngine(our_ac, our_loc, codes, mismatches=2, lut_m=lut, device="cpu")),
        (lambda lut: JaxEditExtendEngine(ac, loc, codes, edits=1, lut_m=lut),
         lambda lut: EditExtendEngine(our_ac, our_loc, codes, edits=1, lut_m=lut, device="cpu")),
    ]
    for jax_make, torch_make in pairs:
        for lut in (0, 4):
            with pytest.raises(ValueError) as want:
                jax_make(lut)
            with pytest.raises(ValueError) as got:
                torch_make(lut)
            assert str(got.value) == str(want.value)


@pytest.fixture
def images(tmp_path):
    n = 3000
    codes = np.random.default_rng(11).integers(0, 4, size=n, dtype=np.uint8)
    ref = tmp_path / "ref.fa"
    write_reference(ref, decode_bases(codes))
    fmi = tmp_path / "ref.fmi"
    jax_cli.main(["build", str(ref), str(n), "--k", "2", "--d", "64", "--output", str(fmi)])
    jax_cli.main(["transform", str(fmi)])
    reads, starts = generate_reads(codes, 24, 64, seed=4, return_starts=True)
    qry = tmp_path / "reads.qry"
    write_reads_fasta(qry, reads, starts)
    return fmi, qry


def test_search_ac_image_with_lut_fails_as_tpufm(tmp_path, images):
    fmi, qry = images
    args = ["search", f"{fmi}.ac", str(qry), "24", "64", "--iterations", "1", "--lut", "4"]
    with pytest.raises(ValueError) as want:
        jax_cli.main(args)
    with pytest.raises(ValueError) as got:
        torch_cli.main(args + ["--device", "cpu"])
    assert str(got.value) == str(want.value) == "lut_m is not supported with alt-counters"


@pytest.mark.parametrize("engine", ["xla", "xla-ac", "pallas"])
def test_search_ac_image_byte_identical(tmp_path, images, engine):
    """``search`` of the .ac image: xla and xla-ac on its slim counters,
    pallas through its base with a LUT (as tpufm's PallasEngine)."""
    fmi, qry = images
    lut = ["--lut", "4"] if engine == "pallas" else []
    args = ["search", f"{fmi}.ac", str(qry), "24", "64", "--iterations", "1", "--engine", engine, *lut]
    jax_cli.main(args + ["--output", str(tmp_path / "jax.res")])
    run = torch_cli.main(args + ["--device", "cpu", "--output", str(tmp_path / "torch.res")])
    assert (tmp_path / "torch.res").read_bytes() == (tmp_path / "jax.res").read_bytes()
    assert run.engine.alt_counters == (engine != "pallas")
    assert (run.results[:, 1] > run.results[:, 0]).all()
