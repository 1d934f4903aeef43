"""The port's SAM/BAM tools (``tpufm_torch.host.bam_index`` and the commands
of ``tpufm_torch.tools``) against tpufm's (tpufm/io/bam_index.py,
tpufm/cli.py:1507-1870) on the same seeded SAM: every function's result,
the sorted BAM and its .bai byte for byte, region queries on edge regions,
and each command's files, standard output, standard error and exit text.
Everything compares exactly (tolerance 0)."""

import shutil

import numpy as np
import pytest

from tpufm import cli as jax_cli
from tpufm.io import bam_index as jbi
from tpufm_torch import cli as torch_cli
from tpufm_torch.host import bam_index as tbi

#: contigs of the seeded SAM: one past 2^26 (the coarsest bins), one short
CONTIGS = [("chrA", 300_000), ("chrB", 70_000_000), ("chrC", 4_000)]
#: the same without the long contig, for coverage over whole contigs
SMALL = [("chrA", 60_000), ("chrC", 4_000)]
BASES = np.frombuffer(b"ACGT", np.uint8)


def _qual(rng, n):
    return "".join(chr(33 + int(q)) for q in rng.integers(2, 41, n))


def _cigar(rng, L):
    a = int(rng.integers(2, L - 4))
    return [f"{L}M", f"3S{L - 3}M", f"{a}M2D{L - a}M", f"{a}M1I{L - a - 1}M",
            f"{a}M300N{L - a}M", f"{a}M{L - a}S", f"2H{L}M"][int(rng.integers(7))]


def _pos(rng, name, ln):
    """1-based POS: uniform, or by a 16 KiB window edge, or past 2^26."""
    pick = int(rng.integers(4))
    if pick == 0 and ln > 1 << 15:
        return int(np.clip((int(rng.integers(1, ln >> 14)) << 14) + int(rng.integers(-30, 30)), 1, ln - 400))
    if pick == 1 and ln > (1 << 26) + 1000:
        return (1 << 26) + int(rng.integers(-200, 800))
    return int(rng.integers(1, ln - 400))


def make_sam(seed: int, n_templates: int, contigs=CONTIGS) -> str:
    """Seeded SAM text, shuffled: single reads on both strands with mixed
    CIGARs (clips, D, I, N) and tags, FR pairs with their TLENs, pairs with
    an unmapped mate placed at its mate, unplaced unmapped reads, secondary,
    supplementary, QC-fail and duplicate-flagged records, records with no
    QUAL, and copies of templates (the duplicates markdup must find)."""
    rng = np.random.default_rng(seed)
    header = ["@HD\tVN:1.6\tSO:unknown"] + [f"@SQ\tSN:{n}\tLN:{ln}" for n, ln in contigs]
    header.append("@PG\tID:tpufm\tPN:tpufm")
    recs = []
    for t in range(n_templates):
        name, ln = contigs[int(rng.integers(len(contigs)))]
        L = int(rng.integers(30, 80))
        seq = BASES[rng.integers(0, 4, L)].tobytes().decode()
        copies = 1 + (t % 9 == 0) + (t % 27 == 0)
        kind = t % 5
        p1 = _pos(rng, name, ln)
        for c in range(copies):
            qn = f"t{t}c{c}"
            q1 = _qual(rng, L) if rng.integers(6) else "*"
            if kind in (0, 1):  # paired, both mapped
                ins = int(rng.integers(L + 10, 350))
                p2 = p1 + ins - L
                rev = bool(rng.integers(2))
                f1, f2 = (83, 163) if rev else (99, 147)
                cig2 = _cigar(rng, L)
                recs.append([qn, str(f1), name, str(p1), "60", _cigar(rng, L), "=", str(p2),
                             str(-ins if rev else ins), seq, q1, f"NM:i:{int(rng.integers(3))}"])
                recs.append([qn, str(f2), name, str(p2), str(int(rng.integers(0, 61))), cig2, "=", str(p1),
                             str(ins if rev else -ins), seq, _qual(rng, L), "AS:i:50"])
            elif kind == 2:  # one mate unmapped, placed at its mate
                recs.append([qn, "73", name, str(p1), "60", f"{L}M", "=", str(p1), "0", seq, q1, "NM:i:0"])
                recs.append([qn, "133", name, str(p1), "0", "*", "=", str(p1), "0", seq, _qual(rng, L)])
            else:
                flag = 16 * int(rng.integers(2)) | [0, 0, 0x100, 0x800, 0x200, 0x400][int(rng.integers(6))]
                recs.append([qn, str(flag), name, str(p1), str(int(rng.integers(0, 61))), _cigar(rng, L),
                             "*", "0", "0", seq, q1, f"NM:i:{int(rng.integers(4))}", "MD:Z:10A5"])
    for u in range(max(3, n_templates // 40)):
        recs.append([f"u{u}", "4", "*", "0", "0", "*", "*", "0", "0", "ACGTACGTAC", "*"])
    order = rng.permutation(len(recs))
    return "\n".join(header + ["\t".join(recs[i]) for i in order]) + "\n"


@pytest.fixture(scope="module")
def sam_text():
    return make_sam(11, 900)


@pytest.fixture(scope="module")
def records(sam_text):
    return [line.split("\t") for line in sam_text.splitlines() if line and not line.startswith("@")]


@pytest.fixture(scope="module")
def bam_pair(sam_text, tmp_path_factory):
    """(tpufm's sorted BAM, the port's), both with their .bai."""
    d = tmp_path_factory.mktemp("bai")
    jbi.write_bam_indexed(str(d / "j.bam"), sam_text)
    tbi.write_bam_indexed(str(d / "t.bam"), sam_text)
    return str(d / "j.bam"), str(d / "t.bam")


def test_sam_spans_members_and_bins(bam_pair, records):
    """The seeded input reaches what it is meant to exercise: several bgzf
    members, records past 2^26 and across 16 KiB windows, every flag kind."""
    from tpufm_torch.host.bam import bgzf_member_at

    blob, off, members = open(bam_pair[1], "rb").read(), 0, 0
    while True:
        chunk, off = bgzf_member_at(blob, off)
        if not chunk:
            break
        members += 1
    assert members >= 4
    flags = [int(f[1]) for f in records]
    assert max(int(f[3]) for f in records) > 1 << 26
    for bit in (0x1, 0x4, 0x10, 0x100, 0x200, 0x400, 0x800):
        assert any(f & bit for f in flags), hex(bit)
    assert any(f[10] == "*" for f in records) and any(f[2] == "*" for f in records)


@pytest.mark.parametrize("beg,end", [(0, 1), (0, 1 << 14), (16383, 16385), (1 << 26, (1 << 26) + 1),
                                     (100, 300_000), (123_456, 123_457), (5, 70_000_000)])
def test_reg2bins(beg, end):
    assert tbi.reg2bins(beg, end) == jbi.reg2bins(beg, end)


def test_sort_sam_text(sam_text):
    assert tbi.sort_sam_text(sam_text) == jbi.sort_sam_text(sam_text)


def test_sort_sam_text_ties_stable_and_header():
    """Equal (contig, POS) keys keep input order; no @HD gains one."""
    text = "@SQ\tSN:a\tLN:100\n" + "".join(f"r{i}\t0\ta\t7\t60\t4M\t*\t0\t0\tACGT\t*\n" for i in range(5))
    assert tbi.sort_sam_text(text) == jbi.sort_sam_text(text)
    with pytest.raises(ValueError) as want:
        jbi.sort_sam_text(text.replace("\ta\t7", "\tzz\t7"))
    with pytest.raises(ValueError) as got:
        tbi.sort_sam_text(text.replace("\ta\t7", "\tzz\t7"))
    assert str(got.value) == str(want.value)


def test_bam_and_bai_bytes(bam_pair):
    j, t = bam_pair
    for suffix in ("", ".bai"):
        assert open(t + suffix, "rb").read() == open(j + suffix, "rb").read()
    assert tbi.load_bai(t + ".bai") == jbi.load_bai(j + ".bai")


def test_build_bai_on_exact_member_multiple():
    """A stream whose length is a BGZF_STEP multiple: the last chunk ends on
    the EOF member (the sentinel offset)."""
    from tpufm_torch.host.bam import BGZF_STEP

    meta = [(0, BGZF_STEP // 2, 0, 5, 15), (BGZF_STEP // 2, BGZF_STEP, 0, 9, 19)]
    offsets = [0, 4000]
    assert tbi.build_bai(meta, offsets, 1) == jbi.build_bai(meta, offsets, 1)
    with pytest.raises(ValueError):
        tbi.build_bai(meta[::-1], offsets, 1)


@pytest.mark.parametrize("region", [("chrA", 0, 300_000), ("chrA", 16_380, 16_390), ("chrA", 0, 1),
                                    ("chrA", 299_990, 300_000), ("chrB", (1 << 26) - 100, (1 << 26) + 100),
                                    ("chrB", 0, 70_000_000), ("chrC", 3_000, 4_000), ("chrC", 10, 11)])
def test_indexed_query(bam_pair, region):
    ji, ti = jbi.IndexedBam(bam_pair[0]), tbi.IndexedBam(bam_pair[1])
    assert (ti.header_text, ti.ref_names, ti.ref_lengths) == (ji.header_text, ji.ref_names, ji.ref_lengths)
    got, want = ti.query(*region), ji.query(*region)
    assert got == want
    assert [tbi.decode_record(r, ti.ref_names) for r in got] == [jbi.decode_record(r, ji.ref_names) for r in want]


def test_flagstat_idxstats_fastq(sam_text, records):
    header = "".join(line + "\n" for line in sam_text.splitlines() if line.startswith("@"))
    assert tbi.flagstat(records) == jbi.flagstat(records)
    assert tbi.idxstats(header, records) == jbi.idxstats(header, records)
    assert list(tbi.fastq_records(records)) == list(jbi.fastq_records(records))
    assert list(tbi.fastq_records(records, qual_fill="#")) == list(jbi.fastq_records(records, qual_fill="#"))


def test_sam_stats(records):
    got, want = tbi.sam_stats(iter(records)), jbi.sam_stats(iter(records))
    assert got == want
    assert [repr(v) for _, v in got["sn"]] == [repr(v) for _, v in want["sn"]]  # int 0 against 0.0


@pytest.mark.parametrize("region,all_positions", [(None, False), (None, True), (("chrA", 100, 5_000), False),
                                                  (("chrA", 100, 5_000), True), (("chrC", 0, None), True)])
def test_depth(region, all_positions):
    text = make_sam(12, 300, SMALL)
    header = "".join(line + "\n" for line in text.splitlines() if line.startswith("@"))
    recs = [line.split("\t") for line in text.splitlines() if line and not line.startswith("@")]
    got = list(tbi.depth(header, recs, region=region, all_positions=all_positions))
    assert got == list(jbi.depth(header, recs, region=region, all_positions=all_positions))
    assert got


def test_bedcov_and_read_bed(tmp_path, bam_pair):
    bed = tmp_path / "r.bed"
    bed.write_text("# comment\ntrack name=x\nchrA\t0\t20000\tfirst\textra\nchrB 67108000 67109000\n"
                   "chrC\t100\t4000\n\nbrowser position chrA\n")
    rows = tbi.read_bed(str(bed))
    assert rows == jbi.read_bed(str(bed))
    ji, ti = jbi.IndexedBam(bam_pair[0]), tbi.IndexedBam(bam_pair[1])
    regions = [r[:3] for r in rows]
    got = list(tbi.bedcov(ti.header_text, lambda c, b, e: [tbi.decode_record(r, ti.ref_names)
                                                           for r in ti.query(c, b, e)], regions))
    want = list(jbi.bedcov(ji.header_text, lambda c, b, e: [jbi.decode_record(r, ji.ref_names)
                                                            for r in ji.query(c, b, e)], regions))
    assert got == want and any(total for *_, total in got)
    bed.write_text("chrA\tx\t5\n")
    with pytest.raises(ValueError) as want_err:
        jbi.read_bed(str(bed))
    with pytest.raises(ValueError) as got_err:
        tbi.read_bed(str(bed))
    assert str(got_err.value) == str(want_err.value)


@pytest.mark.parametrize("cigar", ["50M", "5S45M", "3H2S45M", "20M2D30M", "10M5I35M", "45M5S", "40M3S2H",
                                   "10S", "20M100N30M4S"])
@pytest.mark.parametrize("reverse", [False, True])
def test_unclipped_5p(cigar, reverse):
    assert tbi._unclipped_5p(1000, cigar, reverse) == jbi._unclipped_5p(1000, cigar, reverse)


def test_markdup(records):
    got, n = tbi.markdup(records)
    want, n_want = jbi.markdup(records)
    assert (got, n) == (want, n_want) and n > 0


def test_markdup_ties_keep_input_order():
    """Equal QUAL sums: the earliest template survives, in both packages."""
    recs = [[f"q{i}", "0", "c", "100", "60", "20M", "*", "0", "0", "A" * 20, "I" * 20] for i in range(4)]
    got, want = tbi.markdup(recs), jbi.markdup(recs)
    assert got == want and got[0][0][1] == "0" and got[1] == 3


# ---- the commands, against tpufm.cli.main ---------------------------------


def run_both(tmp_path, monkeypatch, capsys, argv, port_extra=()):
    """Run ``argv`` through tpufm's CLI and the port's, each in its own copy
    of ``tmp_path/in``; return (exit code, stdout, stderr, every file's
    bytes) of each."""
    got = {}
    for name, main, extra in (("jax", jax_cli.main, ()), ("torch", torch_cli.main, port_extra)):
        d = tmp_path / name
        shutil.copytree(tmp_path / "in", d)
        monkeypatch.chdir(d)
        code = None
        try:
            main([*argv, *extra])
        except SystemExit as e:
            code = e.code
        out = capsys.readouterr()
        files = {str(p.relative_to(d)): p.read_bytes() for p in sorted(d.rglob("*")) if p.is_file()}
        got[name] = (code, out.out, out.err, files)
    return got["jax"], got["torch"]


@pytest.fixture
def inputs(tmp_path, sam_text):
    """tmp_path/in with the SAM (a.sam), its sorted BAM and .bai (a.bam),
    two halves of it (h1.sam, h2.sam), a SAM over short contigs (s.sam) and a
    BED file."""
    d = tmp_path / "in"
    d.mkdir()
    (d / "a.sam").write_text(sam_text)
    jbi.write_bam_indexed(str(d / "a.bam"), sam_text)
    lines = sam_text.splitlines()
    head = [x for x in lines if x.startswith("@")]
    body = [x for x in lines if not x.startswith("@")]
    (d / "h1.sam").write_text("\n".join(head + body[::2]) + "\n")
    jbi.write_bam_indexed(str(d / "h2.bam"), "\n".join(head + body[1::2]) + "\n")
    (d / "s.sam").write_text(make_sam(13, 200, SMALL))
    (d / "r.bed").write_text("chrA\t0\t20000\tx\nchrB\t67108000\t67109000\nchrC\t100\t4000\n")
    (d / "other.sam").write_text("@SQ\tSN:zz\tLN:10\n")
    (d / "undeclared.sam").write_text("@SQ\tSN:a\tLN:10\nr\t0\tb\t1\t60\t2M\t*\t0\t0\tAC\t*\n")
    return d


COMMANDS = {
    "sort_sam": ["sort", "a.sam"],
    "sort_bam_output": ["sort", "h2.bam", "--output", "o.bam"],
    "sort_undeclared": ["sort", "undeclared.sam"],
    "view_sam": ["view", "a.sam"],
    "view_bam_no_header": ["view", "a.bam", "--no-header", "--output", "v.sam"],
    "view_region": ["view", "a.bam", "chrA:16300-16500"],
    "view_region_past_2_26": ["view", "a.bam", "chrB:67108000-67109500"],
    "view_whole_contig": ["view", "a.bam", "chrC"],
    "view_region_begin_zero": ["view", "a.bam", "chrA:0-20000", "--no-header"],
    "view_not_a_contig": ["view", "a.bam", "chrZ:1-10"],
    "view_bad_region": ["view", "a.bam", "chrA:10"],
    "view_empty_region": ["view", "a.bam", "chrA:50-10"],
    "view_no_bai": ["view", "a.sam", "chrA:1-10"],
    "flagstat_sam": ["flagstat", "a.sam"],
    "flagstat_bam": ["flagstat", "a.bam"],
    "idxstats": ["idxstats", "a.bam"],
    "markdup_bam": ["markdup", "a.sam"],
    "markdup_sam": ["markdup", "a.bam", "--output", "m.sam"],
    "stats": ["stats", "a.sam"],
    "stats_output": ["stats", "a.bam", "--output", "st.txt"],
    "bedcov_indexed": ["bedcov", "a.bam", "r.bed"],
    "bedcov_sam": ["bedcov", "a.sam", "r.bed", "--output", "bc.txt"],
    "depth_region_indexed": ["depth", "a.bam", "chrA:16000-17000"],
    "depth_sam_all": ["depth", "s.sam", "-a"],
    "depth_sam_region": ["depth", "s.sam", "chrC:10-400", "--output", "dp.txt"],
    "depth_not_a_contig": ["depth", "a.bam", "chr:1-5"],
    "fastq_one_stream": ["fastq", "a.sam"],
    "fastq_paired_files": ["fastq", "a.bam", "-1", "r1.fq", "-2", "r2.fq", "--output", "single.fq"],
    "fastq_one_file_only": ["fastq", "a.bam", "-1", "r1.fq"],
    "merge": ["merge", "mg.bam", "h1.sam", "h2.bam"],
    "merge_differing_sq": ["merge", "mg.bam", "h1.sam", "other.sam"],
}


@pytest.mark.parametrize("case", sorted(COMMANDS))
def test_command_matches_tpufm(case, inputs, tmp_path, monkeypatch, capsys):
    want, got = run_both(tmp_path, monkeypatch, capsys, COMMANDS[case])
    assert got == want
    code, out, _, files = got
    assert code is not None or out or len(files) > len(list(inputs.iterdir()))


def test_sort_then_view_region_round_trip(inputs, tmp_path, monkeypatch, capsys):
    """The port's own sort, then its region view: every record of a region
    overlapping it, as a linear filter of the sorted records finds them."""
    monkeypatch.chdir(inputs)
    torch_cli.main(["sort", "a.sam", "--output", "p.bam"])
    assert capsys.readouterr().out == "wrote p.bam + p.bam.bai\n"
    torch_cli.main(["view", "p.bam", "--no-header"])
    whole = [x.split("\t") for x in capsys.readouterr().out.splitlines()]
    torch_cli.main(["view", "p.bam", "chrA:1000-90000", "--no-header"])
    region = [x.split("\t") for x in capsys.readouterr().out.splitlines()]

    def span(f):
        return sum(int(n) for n, op in tbi._cig_ops(f[5]) if op in "MDN=X")

    want = [f for f in whole if f[2] == "chrA" and int(f[3]) - 1 < 90000
            and int(f[3]) - 1 + max(span(f), 1) > 999]
    assert region == want and region
