"""``python -m tpufm_torch.cli align`` and ``locate --sam/--bam/--contigs``
with ``--device cpu`` against ``tpufm align`` / ``tpufm locate`` on the same
seeded reference and reads: the SAM, BAM, ``.pos`` and ``.pairs`` files
must be byte-identical (tolerance 0), and so must what each prints; the
argument errors exit with tpufm's messages."""

import numpy as np
import pytest

from tpufm import cli as jax_cli
from tpufm_torch import cli as torch_cli
from tpufm_torch.host.bam import read_bam
from tpufm_torch.host.seqio import decode_bases, generate_read_pairs, reverse_complement

RECORDS = (1500, 900, 2100, 700)
BASES = sum(RECORDS)


def _fastq(path, reads, rng):
    with open(path, "w") as fp:
        for i, r in enumerate(reads):
            q = "".join(chr(33 + int(x)) for x in rng.integers(0, 41, size=len(r)))
            fp.write(f"@q{i} x\n{decode_bases(r).decode()}\n+\n{q}\n")
    return str(path)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A 4-record reference and the read files every test shares: fixed
    40 bp FASTQ (half reverse-complemented, a quarter with a substitution,
    one with two edits in four), FR pairs of 36 bp, mixed 30/36/45 bp reads,
    and mates of other lengths."""
    d = tmp_path_factory.mktemp("align")
    rng = np.random.default_rng(71)
    recs = [rng.integers(0, 4, size=n, dtype=np.uint8) for n in RECORDS]
    codes = np.concatenate(recs)
    with open(d / "g.fa", "wb") as fp:
        for i, r in enumerate(recs):
            s = decode_bases(r)
            fp.write(b">chr%d desc\n" % (i + 1) + b"\n".join(s[o:o + 60] for o in range(0, len(s), 60)) + b"\n")
    starts = rng.integers(0, BASES - 200, size=64)
    fixed = [codes[s:s + 40].copy() for s in starts]
    for i in range(64):
        if i % 4 == 1:
            fixed[i][7] = (fixed[i][7] + 1) % 4
        if i % 4 == 3:  # a deletion and a substitution
            fixed[i] = np.concatenate([codes[starts[i]:starts[i] + 12], codes[starts[i] + 13:starts[i] + 41]])
            fixed[i][30] = (fixed[i][30] + 2) % 4
        if i % 2:
            fixed[i] = reverse_complement(fixed[i])
    r1, r2 = generate_read_pairs(codes, 36, 48, 100, 300, seed=3)
    r1 = np.array(r1)
    r1[::3, 9] = (r1[::3, 9] + 1) % 4
    lens = rng.choice([30, 36, 45], size=64)
    mixed = [codes[s:s + n].copy() for s, n in zip(starts, lens)]
    for i in range(0, 64, 2):
        mixed[i] = reverse_complement(mixed[i])
    for i in range(1, 64, 5):
        mixed[i][4] = (mixed[i][4] + 1) % 4
    mates = [reverse_complement(codes[s + 150:s + 150 + n]) for s, n in zip(starts[:48], rng.choice([30, 36], 48))]
    short_mates = [reverse_complement(codes[s + 150:s + 180]) for s in starts[:48]]
    return {
        "dir": d, "ref": str(d / "g.fa"), "fixed": _fastq(d / "fixed.fq", fixed, rng),
        "r1": _fastq(d / "r1.fq", r1, rng), "r2": _fastq(d / "r2.fq", r2, rng),
        "mixed": _fastq(d / "mixed.fq", mixed, rng), "mixed1": _fastq(d / "mixed1.fq", mixed[:48], rng),
        "mates": _fastq(d / "mates.fq", mates, rng), "u1": _fastq(d / "u1.fq", [m[:36] for m in fixed[:48]], rng),
        "u2": _fastq(d / "u2.fq", short_mates, rng), "fewer": _fastq(d / "fewer.fq", r1[:47], rng),
    }


def _both(capsys, argv_jax, argv_torch, out_jax, out_torch, store_jax="OUT", store_torch="OUT"):
    """Run tpufm, then the port; both outputs byte-identical and both
    printing the same lines (the output and store names aside)."""
    jax_cli.main(argv_jax)
    said_jax = capsys.readouterr().out.replace(out_jax, "OUT").replace(store_jax, "STORE")
    run = torch_cli.main(argv_torch)
    said_torch = capsys.readouterr().out.replace(out_torch, "OUT").replace(store_torch, "STORE")
    with open(out_jax, "rb") as a, open(out_torch, "rb") as b:
        assert b.read() == a.read()
    assert said_torch == said_jax
    return run


ALIGN_FORMS = {
    "exact": ("fixed", []), "m1": ("fixed", ["--mismatches", "1"]), "m2": ("fixed", ["--mismatches", "2"]),
    "e1": ("fixed", ["--edits", "1"]), "e2-bam": ("fixed", ["--edits", "2", "--bam"]),
    "exact-bam": ("fixed", ["--bam"]), "m1-bam": ("fixed", ["--mismatches", "1", "--bam"]),
    "paired": ("r1", ["-2", "R2"]), "paired-m1": ("r1", ["-2", "R2", "--mismatches", "1"]),
    "paired-m2-bam": ("r1", ["-2", "R2", "--mismatches", "2", "--bam"]),
    "paired-e1": ("r1", ["-2", "R2", "--edits", "1"]),
    "mixed": ("mixed", []), "mixed-bam": ("mixed", ["--bam", "--max-hits", "3"]),
    "mixed-m1": ("mixed", ["--mismatches", "1"]), "mixed-m2": ("mixed", ["--mismatches", "2"]),
    "mixed-e1": ("mixed", ["--edits", "1"]),
    "mixed-paired": ("mixed1", ["-2", "MATES", "--insert-max", "400"]),
    "mixed-paired-e1-bam": ("mixed1", ["-2", "MATES", "--insert-max", "400", "--edits", "1", "--bam"]),
    "unequal-mates-m1": ("u1", ["-2", "U2", "--insert-max", "400", "--mismatches", "1"]),
}


@pytest.mark.parametrize("form", list(ALIGN_FORMS))
def test_align_byte_identical(data, tmp_path, capsys, form):
    reads, extra = ALIGN_FORMS[form]
    extra = [{"R2": data["r2"], "MATES": data["mates"], "U2": data["u2"]}.get(x, x) for x in extra]
    common = ["align", data["ref"], data[reads], "--sample-rate", "8", "--max-hits", "6"]
    run = _both(capsys, [*common, *extra, "-o", str(tmp_path / "j.out")],
                [*common, *extra, "-o", str(tmp_path / "t.out"), "--device", "cpu"],
                str(tmp_path / "j.out"), str(tmp_path / "t.out"))
    text = torch_cli.read_sam_or_bam(str(tmp_path / "t.out"))  # SAM, or BAM decoded to SAM
    assert text == jax_cli._read_sam_or_bam(str(tmp_path / "j.out")) and text.startswith("@HD\tVN:1.6")
    if "--bam" in extra:
        assert read_bam(tmp_path / "t.out")[1] == [x.split("\t") for x in text.splitlines() if x[0] != "@"]
    mapped = [x for x in text.splitlines() if x[0] != "@" and not int(x.split("\t")[1]) & 4]
    assert len(mapped) >= 20  # most reads place
    assert "tables" in run.stages and "emit" in run.stages


def test_align_store_then_from_store(data, tmp_path, capsys):
    """``--store`` by each package, ``--from-store`` by the other: the same
    SAM as a build from the reference."""
    common = ["align", data["ref"], data["fixed"], "--sample-rate", "8"]
    _both(capsys, [*common, "--store", str(tmp_path / "J"), "-o", str(tmp_path / "j.sam")],
          [*common, "--store", str(tmp_path / "T"), "-o", str(tmp_path / "t.sam"), "--device", "cpu"],
          str(tmp_path / "j.sam"), str(tmp_path / "t.sam"), str(tmp_path / "J"), str(tmp_path / "T"))
    for store, extra in (("J", ["--mismatches", "1"]), ("T", ["--edits", "1"])):
        argv = ["align", data["ref"], data["fixed"], "--from-store", str(tmp_path / store), *extra]
        _both(capsys, [*argv, "-o", str(tmp_path / "j2.sam")],
              [*argv, "-o", str(tmp_path / "t2.sam"), "--device", "cpu"],
              str(tmp_path / "j2.sam"), str(tmp_path / "t2.sam"))


LOCATE_FORMS = {
    "sam": ["--sam"], "sam-m1": ["--sam", "--mismatches", "1"], "bam-m2": ["--bam", "--mismatches", "2"],
    "sam-e1": ["--sam", "--edits", "1"], "contigs": ["--contigs"], "contigs-rc": ["--contigs", "--rc", "--fused"],
    "contigs-e1": ["--contigs", "--edits", "1"], "contigs-m2": ["--contigs", "--mismatches", "2"],
    "paired-sam": ["--paired", "R2", "--sam"], "paired-bam-m2": ["--paired", "R2", "--bam", "--mismatches", "2"],
    "paired-sam-e1": ["--paired", "R2", "--sam", "--edits", "1"], "paired-contigs": ["--paired", "R2", "--contigs"],
}


@pytest.mark.parametrize("form", list(LOCATE_FORMS))
def test_locate_sam_bam_contigs_byte_identical(data, tmp_path, capsys, form):
    extra = [data["r2"] if x == "R2" else x for x in LOCATE_FORMS[form]]
    argv = ["locate", data["ref"], str(BASES), data["r1"], "36", "48", "--k", "2", "--d", "64",
            "--sample-rate", "8", "--max-hits", "5", "--insert-max", "300", *extra]
    run = _both(capsys, [*argv, "--output", str(tmp_path / "j.out")],
                [*argv, "--output", str(tmp_path / "t.out"), "--device", "cpu"],
                str(tmp_path / "j.out"), str(tmp_path / "t.out"))
    if "--rc" in extra:
        assert (tmp_path / "t.out.rc").read_bytes() == (tmp_path / "j.out.rc").read_bytes()
    if "--contigs" in extra:
        assert b"chr" in (tmp_path / "t.out").read_bytes()
    else:
        assert run.output == str(tmp_path / "t.out")


def test_locate_sam_from_store_and_default_names(data, tmp_path, capsys, monkeypatch):
    """Exact SAM from a store needs only the record map; --mismatches 1
    reads the text again for NM. The default output is <queries>.sam."""
    monkeypatch.chdir(tmp_path)
    tail = [data["r1"], "36", "48", "--k", "2", "--d", "64", "--sample-rate", "8"]
    jax_cli.main(["locate", data["ref"], str(BASES), *tail, "--store", "P", "--output", "x.pos"])
    for extra in ([], ["--mismatches", "1"]):
        jax_cli.main(["locate", data["ref"], "0", *tail, "--from-store", "P", "--sam", *extra])
        want = open(data["r1"] + ".sam", "rb").read()
        torch_cli.main(["locate", data["ref"], "0", *tail, "--from-store", "P", "--sam", *extra, "--device", "cpu"])
        assert open(data["r1"] + ".sam", "rb").read() == want
    capsys.readouterr()


@pytest.mark.parametrize(
    "argv",
    [["locate", "REF", str(BASES), "R1", "36", "48", "--sam", "--rc"],
     ["locate", "REF", str(BASES), "R1", "36", "48", "--paired", "R2", "--sam", "--rc"],
     ["locate", "NOREF", str(BASES), "R1", "36", "48", "--from-store", "STORE", "--sam"],
     ["locate", "NOREF", str(BASES), "R1", "36", "48", "--from-store", "STORE", "--contigs"],
     ["align", "REF", "R1", "-2", "FEWER"], ["align", "NOREF", "R1"], ["align", "REF", "EMPTY"],
     ["align", "REF", "R1", "--from-store", "NOSTORE"]],
    ids=["sam-rc", "paired-sam-rc", "sam-no-fasta", "contigs-no-fasta", "mate-counts", "no-reference",
         "no-reads", "no-store"],
)
def test_errors_as_tpufm(data, tmp_path, argv):
    jax_cli.main(["locate", data["ref"], str(BASES), data["r1"], "36", "48", "--k", "2", "--d", "64",
                  "--store", str(tmp_path / "S"), "--output", str(tmp_path / "s.pos")])
    (tmp_path / "empty.fq").write_text("")
    subst = {"REF": data["ref"], "NOREF": str(tmp_path / "none.fa"), "R1": data["r1"], "R2": data["r2"],
             "FEWER": data["fewer"], "STORE": str(tmp_path / "S"), "EMPTY": str(tmp_path / "empty.fq"),
             "NOSTORE": str(tmp_path / "none")}
    argv = [subst.get(x, x) for x in argv]
    with pytest.raises(SystemExit) as theirs:
        jax_cli.main(argv)
    with pytest.raises(SystemExit) as ours:
        torch_cli.main([*argv, "--device", "cpu"])
    assert isinstance(ours.value.code, str) and ours.value.code == theirs.value.code


@pytest.mark.parametrize("option,item", [(["--mesh", "4"], "item 6"), (["--mesh", "0"], "item 6"),
                                         (["--on-device"], "item 4")])
def test_align_unported_options_exit_naming_their_item(data, tmp_path, capsys, option, item):
    """Each option is ported (``item``: the ROADMAP Queue 1 item that ported
    it): ``--mesh 4`` and ``--mesh 0`` (item 6, the mesh locate: four CPU
    shards, and every device, which is one CPU shard here and tpufm's eight
    virtual devices) and ``--on-device`` (item 4, the device build). Each
    SAM equals tpufm's ``align`` with the same option, and so does what
    each prints."""
    ours, theirs = str(tmp_path / "torch.sam"), str(tmp_path / "jax.sam")
    _both(capsys, ["align", data["ref"], data["fixed"], *option, "-o", theirs],
          ["align", data["ref"], data["fixed"], *option, "-o", ours, "--device", "cpu"], theirs, ours)


def test_align_needs_the_card_by_default(data, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        torch_cli.main(["align", data["ref"], data["fixed"], "-o", str(tmp_path / "x.sam")])
    assert not (tmp_path / "x.sam").exists()
