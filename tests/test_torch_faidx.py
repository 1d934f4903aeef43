"""The port's FASTA index (``tpufm_torch.host.faidx`` and the ``faidx``
command) against tpufm's (tpufm/io/faidx.py, tpufm/cli.py:1824): the .fai
bytes, the fetched bases, and the errors (gzip input, ragged lines, an
empty name, data before a header, no records, an unknown sequence), text
for text. Bytes compare exactly (tolerance 0)."""

import gzip
import shutil

import numpy as np
import pytest

from tpufm import cli as jax_cli
from tpufm.io import faidx as jfx
from tpufm_torch import cli as torch_cli
from tpufm_torch.host import faidx as tfx

ACGT = np.frombuffer(b"ACGT", np.uint8)


def _fasta(rng, widths, lengths, eol=b"\n", names=None):
    """A multi-FASTA with one record per length, wrapped at its width."""
    out = []
    for i, (w, n) in enumerate(zip(widths, lengths)):
        seq = ACGT[rng.integers(0, 4, n)].tobytes()
        name = names[i] if names else b"seq%d description %d" % (i, i)
        out.append(b">" + name + eol + b"".join(seq[o:o + w] + eol for o in range(0, n, w)))
    return b"".join(out)


LAYOUTS = {
    "one_record": dict(widths=[60], lengths=[1000]),
    "uneven_records": dict(widths=[60, 70, 13, 80], lengths=[1, 999, 130, 4000]),
    "crlf": dict(widths=[50, 61], lengths=[777, 61], eol=b"\r\n"),
    "exact_lines": dict(widths=[32, 32], lengths=[64, 96]),
    "empty_record": dict(widths=[60, 60, 60], lengths=[100, 0, 50]),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_fai_bytes_and_fetch(layout, tmp_path):
    rng = np.random.default_rng(len(layout))
    data = _fasta(rng, **LAYOUTS[layout])
    (tmp_path / "j.fa").write_bytes(data)
    (tmp_path / "t.fa").write_bytes(data)
    rows = tfx.build_fai(str(tmp_path / "t.fa"))
    assert rows == jfx.build_fai(str(tmp_path / "j.fa"))
    assert (tmp_path / "t.fa.fai").read_bytes() == (tmp_path / "j.fa.fai").read_bytes()
    fai = tfx.load_fai(str(tmp_path / "t.fa"))
    assert fai == jfx.load_fai(str(tmp_path / "j.fa.fai"))
    for name, (length, *_rest) in fai.items():
        regions = [(0, None), (-5, 3), (length - 1, length + 10), (length, length), (7, 6)]
        regions += [tuple(sorted(int(x) for x in rng.integers(0, length + 1, 2))) for _ in range(20)]
        for beg, end in regions:
            got = tfx.fetch(str(tmp_path / "t.fa"), name, beg, end, fai=fai)
            assert got == jfx.fetch(str(tmp_path / "j.fa"), name, beg, end)
    # no .fai yet: fetch builds it
    (tmp_path / "n.fa").write_bytes(data)
    first = rows[0][0]
    assert tfx.fetch(str(tmp_path / "n.fa"), first, 0, 5) == jfx.fetch(str(tmp_path / "j.fa"), first, 0, 5)
    assert (tmp_path / "n.fa.fai").exists()


BAD = {
    "gzip": gzip.compress(b">c\nACGT\n"),
    "ragged_short_inside": b">c\nACGTACGT\nACG\nACGTACGT\n",
    "ragged_long": b">c\nACGT\nACGTACGT\n",
    "blank_inside": b">c\nACGT\n\nACGT\n",
    "empty_name": b">\nACGT\n",
    "blank_name": b">   \nACGT\n",
    "before_header": b"ACGT\n>c\nACGT\n",
    "no_records": b"\n\n",
}
GOOD = {
    "short_last_line": b">c\nACGTACGT\nACG\n",
    "blank_after_records": b">c\nACGT\nAC\n\n\n>d\nGGGG\n",
    "blank_before_bases": b">c\n\nACGT\nAC\n",
}


@pytest.mark.parametrize("case", sorted(BAD) + sorted(GOOD))
def test_fai_errors_and_edge_layouts(case, tmp_path):
    data = {**BAD, **GOOD}[case]
    (tmp_path / "j.fa").write_bytes(data)
    (tmp_path / "t.fa").write_bytes(data)
    if case in BAD:
        with pytest.raises(ValueError) as want:
            jfx.build_fai(str(tmp_path / "j.fa"))
        with pytest.raises(ValueError) as got:
            tfx.build_fai(str(tmp_path / "t.fa"))
        assert str(got.value) == str(want.value).replace("j.fa", "t.fa")
        return
    assert tfx.build_fai(str(tmp_path / "t.fa")) == jfx.build_fai(str(tmp_path / "j.fa"))
    assert (tmp_path / "t.fa.fai").read_bytes() == (tmp_path / "j.fa.fai").read_bytes()
    name = tfx.load_fai(str(tmp_path / "t.fa"))
    for n in name:
        assert tfx.fetch(str(tmp_path / "t.fa"), n) == jfx.fetch(str(tmp_path / "j.fa"), n)


def test_fetch_unknown_name(tmp_path):
    data = _fasta(np.random.default_rng(3), [10] * 10, [20] * 10, names=[b"n%d" % i for i in range(10)])
    (tmp_path / "a.fa").write_bytes(data)
    with pytest.raises(KeyError) as want:
        jfx.fetch(str(tmp_path / "a.fa"), "zz")
    with pytest.raises(KeyError) as got:
        tfx.fetch(str(tmp_path / "a.fa"), "zz")
    assert got.value.args == want.value.args


CLI = {
    "index": ["faidx", "g.fa"],
    "regions": ["faidx", "g.fa", "seq1", "seq1:10-200", "seq3:1-1", "seq0:0-1", "seq1:990-5000"],
    "regions_output": ["faidx", "g.fa", "seq2:5-100", "--output", "out.fa"],
    "unknown": ["faidx", "g.fa", "nope:1-5"],
    "bad_region": ["faidx", "g.fa", "seq1:5"],
    "ragged": ["faidx", "ragged.fa"],
    "ragged_regions": ["faidx", "ragged.fa", "c:1-2"],
    "gzip": ["faidx", "g.fa.gz"],
}


@pytest.mark.parametrize("case", sorted(CLI))
def test_faidx_command_matches_tpufm(case, tmp_path, monkeypatch, capsys):
    src = tmp_path / "in"
    src.mkdir()
    data = _fasta(np.random.default_rng(9), **LAYOUTS["uneven_records"])
    (src / "g.fa").write_bytes(data)
    (src / "g.fa.gz").write_bytes(gzip.compress(data))
    (src / "ragged.fa").write_bytes(BAD["ragged_short_inside"])
    got = {}
    for name, main in (("jax", jax_cli.main), ("torch", torch_cli.main)):
        d = tmp_path / name
        shutil.copytree(src, d)
        monkeypatch.chdir(d)
        code = None
        try:
            main(CLI[case])
        except SystemExit as e:
            code = e.code
        out = capsys.readouterr()
        got[name] = (code, out.out, out.err,
                     {p.name: p.read_bytes() for p in sorted(d.iterdir())})
    assert got["torch"] == got["jax"]
