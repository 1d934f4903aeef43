"""``transform`` and the alternate-counters writer of the port
(``tpufm_torch.host.layouts``, ``write_fmi`` tags 200/201) and the debug
commands ``dumpentry``, ``diff`` and ``dumpbwt``, against tpufm's
(tpufm/index/layouts.py, tpufm/index/formats.py:56-84, tpufm/cli.py:158,
:707, :1871, :1888): ``make_alt_counters`` in both semantics and the three
images' bytes at k 1-4, for odd and even entry counts and bwtsize % d zero
and not; each image read back by the port equal to the baseline index it
came from and searching to its intervals; the commands' standard output and
exit texts. Everything compares exactly (tolerance 0)."""

import shutil

import numpy as np
import pytest

from tpufm import cli as jax_cli
from tpufm.config import IndexConfig as JaxIndexConfig
from tpufm.engine.oracle import search_oracle
from tpufm.index import layouts as jax_layouts
from tpufm.index.builder import build_index as jax_build_index
from tpufm.io.fasta import write_reference
from tpufm.io.results import write_results
from tpufm.utils.encoding import decode_bases
from tpufm_torch import SearchEngine
from tpufm_torch import cli as torch_cli
from tpufm_torch.host import layouts
from tpufm_torch.host.formats import read_fmi
from tpufm_torch.host.index import IndexConfig, build_index, derive_bwts

D = 64
#: text lengths n (bwtsize n + 1) at d = 64: (entries, bwtsize % d)
SIZES = {
    "even_partial": 200,  # bwtsize 201: 4 entries, 9 past the last boundary
    "odd_partial": 150,  # 151: 3 entries, 23
    "even_exact": 127,  # 128: 2 entries, bwtsize % d == 0
    "odd_exact": 191,  # 192: 3 entries, bwtsize % d == 0
}
IMAGES = (".interleaving", ".ac", ".interleaving.ac")


def _codes(case, k):
    return np.random.default_rng(100 * k + SIZES[case]).integers(0, 4, SIZES[case], dtype=np.uint8)


@pytest.mark.parametrize("semantics", [False, True])
@pytest.mark.parametrize("case", sorted(SIZES))
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_make_alt_counters(k, case, semantics):
    codes = _codes(case, k)
    index = build_index(codes, IndexConfig(k=k, d=D))
    want = jax_layouts.make_alt_counters(jax_build_index(codes, JaxIndexConfig(k=k, d=D)),
                                         reference_semantics=semantics)
    got = layouts.make_alt_counters(index, reference_semantics=semantics)
    np.testing.assert_array_equal(got.occ_slim, want.occ_slim)
    assert got.occ_slim.dtype == np.uint32 and got.base is index


def test_interleave_words():
    bm = np.arange(3 * 4 * 2 * 6, dtype=np.uint32).reshape(3, 4, 2, 6)
    il = layouts.interleave_bitmap_words(bm)
    np.testing.assert_array_equal(il, jax_layouts.interleave_bitmap_words(bm))
    np.testing.assert_array_equal(layouts.deinterleave_bitmap_words(il), bm)


def _run(main, argv, capsys):
    code = None
    try:
        main(argv)
    except SystemExit as e:
        code = e.code
    out = capsys.readouterr()
    return code, out.out, out.err


@pytest.fixture
def fmi_pair(tmp_path, capsys):
    """(k, case) -> two copies (jax/, torch/) of the baseline .fmi of the
    case's text, written by tpufm's ``build``."""
    def make(k, case):
        codes = _codes(case, k)
        src = tmp_path / f"src{k}{case}"
        src.mkdir()
        write_reference(src / "ref.fa", decode_bases(codes))
        jax_cli.main(["build", str(src / "ref.fa"), str(codes.size), "--k", str(k), "--d", str(D),
                      "--output", str(src / "ref.fmi")])
        capsys.readouterr()
        out = []
        for name in ("jax", "torch"):
            d = tmp_path / f"{name}{k}{case}"
            shutil.copytree(src, d)
            out.append(d / "ref.fmi")
        return codes, out
    return make


@pytest.mark.parametrize("case", sorted(SIZES))
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_transform_images(k, case, fmi_pair, capsys):
    """The three images byte-identical to tpufm's ``transform``; each read
    back by the port equal to the baseline index and searching to its
    intervals (never held against tpufm's reader, which keeps the last
    block's padding in an even image's logical counters)."""
    codes, (jfmi, tfmi) = fmi_pair(k, case)
    jax_cli.main(["transform", str(jfmi)])
    want = capsys.readouterr().out
    torch_cli.main(["transform", str(tfmi)])
    assert capsys.readouterr().out == want.replace(str(jfmi.parent), str(tfmi.parent))
    baseline = build_index(codes, IndexConfig(k=k, d=D))
    rng = np.random.default_rng(k)
    L = 4 * k
    starts = rng.integers(0, codes.size - L, 24)
    reads = np.concatenate([codes[starts[:, None] + np.arange(L)],
                            rng.integers(0, 4, (8, L), dtype=np.uint8)])
    want_iv = search_oracle(jax_build_index(codes, JaxIndexConfig(k=k, d=D)), reads)
    for suffix in IMAGES:
        assert (tfmi.parent / f"ref.fmi{suffix}").read_bytes() == (jfmi.parent / f"ref.fmi{suffix}").read_bytes()
        back, layout = read_fmi(tfmi.parent / f"ref.fmi{suffix}")
        assert layout.has_slim_counters == suffix.endswith(".ac")
        base = getattr(back, "base", back)
        for field in ("occ", "bitmaps", "dollar_pos", "dollar_base"):
            np.testing.assert_array_equal(getattr(base, field), getattr(baseline, field))
        np.testing.assert_array_equal(SearchEngine(back, "cpu").search(reads), want_iv)


def test_transform_layout_subset_and_refusal(fmi_pair, capsys):
    _, (jfmi, tfmi) = fmi_pair(2, "odd_partial")
    args = ["--layouts", "alt_counters"]
    assert _run(torch_cli.main, ["transform", str(tfmi), *args], capsys)[0] is None
    jax_cli.main(["transform", str(jfmi), *args])
    capsys.readouterr()
    assert sorted(p.name for p in tfmi.parent.iterdir()) == sorted(p.name for p in jfmi.parent.iterdir())
    want = _run(jax_cli.main, ["transform", f"{jfmi}.ac"], capsys)
    got = _run(torch_cli.main, ["transform", f"{tfmi}.ac"], capsys)
    assert got == want and want[0] == "transform expects a tag-100 baseline .fmi"


@pytest.mark.parametrize("image", ["", ".interleaving", ".ac", ".interleaving.ac"])
@pytest.mark.parametrize("case", ["even_partial", "odd_exact"])
def test_dumpentry(image, case, fmi_pair, capsys):
    """Every entry, the appended end-of-text row included, and a range
    running past the table."""
    _, (jfmi, tfmi) = fmi_pair(2, case)
    jax_cli.main(["transform", str(jfmi)])
    torch_cli.main(["transform", str(tfmi)])
    capsys.readouterr()
    n = -(-(SIZES[case] + 1) // D)
    for entry, num in ((0, 1), (0, n + 1), (n, 1), (n - 1, 5)):
        want = _run(jax_cli.main, ["dumpentry", f"{jfmi}{image}", str(entry), "--num", str(num)], capsys)
        got = _run(torch_cli.main, ["dumpentry", f"{tfmi}{image}", str(entry), "--num", str(num)], capsys)
        assert got == want and "entry" in got[1]


def test_dumpentry_store_and_npz(tmp_path, capsys):
    codes = np.random.default_rng(5).integers(0, 4, 500, dtype=np.uint8)
    write_reference(tmp_path / "r.fa", decode_bases(codes))
    for out in ("r.npz", "r.tpufm"):
        jax_cli.main(["build", str(tmp_path / "r.fa"), "500", "--k", "3", "--d", "64",
                      "--output", str(tmp_path / out)])
        capsys.readouterr()
        want = _run(jax_cli.main, ["dumpentry", str(tmp_path / out), "2", "--num", "3"], capsys)
        assert _run(torch_cli.main, ["dumpentry", str(tmp_path / out), "2", "--num", "3"], capsys) == want


@pytest.mark.parametrize("case", ["identical", "differ", "differ_many", "shapes"])
def test_diff(case, tmp_path, capsys):
    rng = np.random.default_rng(4)
    a = rng.integers(0, 1 << 31, (40, 2), dtype=np.uint32)
    b = a.copy()
    if case == "differ":
        b[[3, 17], 1] += 1
    elif case == "differ_many":
        b[::2, 0] += 1
    elif case == "shapes":
        b = b[:39]
    write_results(tmp_path / "a.res", a)
    write_results(tmp_path / "b.res", b)
    argv = ["diff", str(tmp_path / "a.res"), str(tmp_path / "b.res")]
    got = _run(torch_cli.main, argv, capsys)
    assert got == _run(jax_cli.main, argv, capsys)
    assert (got[0] is None) == (case == "identical")


@pytest.mark.parametrize("k", [1, 2, 3])
def test_dumpbwt(k, tmp_path, capsys):
    codes = np.random.default_rng(k).integers(0, 4, 300, dtype=np.uint8)
    write_reference(tmp_path / "r.fa", decode_bases(codes))
    argv = ["dumpbwt", str(tmp_path / "r.fa"), "250", "--k", str(k)]
    got = _run(torch_cli.main, argv, capsys)
    assert got == _run(jax_cli.main, argv, capsys)
    bwts, dollar = derive_bwts(codes[:250], k)
    assert len(bwts) == k and all(b.count(b"$") == 1 and len(b) == 251 for b in bwts)
    assert [b.index(b"$") for b in bwts] == dollar.tolist()
