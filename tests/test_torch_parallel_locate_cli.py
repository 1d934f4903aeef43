"""``python -m tpufm_torch.cli locate --mesh N``, ``align --mesh N`` and
``bench --locate --mesh N`` with ``--device cpu`` (N CPU shards) against
tpufm's CLI on its virtual CPU devices (tests/conftest.py: 8), on the same
4-record reference and reads: the ``.pos`` (and ``.pos.rc``), ``.pairs``,
SAM and BAM files and the standard output byte-identical, in every locate
form (two-pass, ``--fused``, ``--rc``, ``--lut``, any length, Hamming 1 and
2, edits, ``--sam``, ``--bam``, ``--contigs``, ``--paired``) and every align
form (fixed, paired, mixed exact, mixed approximate, mixed paired);
``locate --mesh 3 --resume`` killed after one wave and finished by either
package; the ``bench --locate --mesh 8`` record field by field (times
aside). Positions are integers (tolerance 0)."""

import json
import shutil

import numpy as np
import pytest
from test_torch_align import _both, data  # noqa: F401 (data is a fixture)

from tpufm import cli as jax_cli
from tpufm.parallel import DataParallelSearchLocate as JaxDPSL
from tpufm_torch import cli as torch_cli
from tpufm_torch.host.seqio import generate_read_pairs, read_reference, write_reads_fasta
from tpufm_torch.parallel import DataParallelSearchLocate

L, B, REFSIZE = 24, 100, 5200


@pytest.fixture(scope="module")
def files(data):  # noqa: F811 (the fixture imported above)
    """``data``'s directory with locate inputs: q.qry (100 x 24 bp, every
    third read with a substitution, every fifth with an indel), q25.qry (25
    bp: one k=1 tail round at k=2) and FR pairs p_1.qry / p_2.qry."""
    d = data["dir"]
    codes = read_reference(data["ref"], REFSIZE)
    rng = np.random.default_rng(29)
    starts = rng.integers(0, REFSIZE - L - 2, size=B)
    reads = codes[starts[:, None] + np.arange(L)].copy()
    reads[::3, 5] = (reads[::3, 5] + 1) % 4
    for i in range(0, B, 5):
        reads[i] = np.concatenate([codes[starts[i]:starts[i] + 10], codes[starts[i] + 11:starts[i] + L + 1]])
    write_reads_fasta(d / "q.qry", reads, starts)
    write_reads_fasta(d / "q25.qry", codes[starts[:, None] + np.arange(L + 1)])
    r1, r2 = generate_read_pairs(codes, L, 40, 80, 300, seed=5)
    write_reads_fasta(d / "p_1.qry", r1)
    write_reads_fasta(d / "p_2.qry", r2)
    return d


def _run(main, argv, capsys):
    """(exit code or None, stdout lines without TIME:) of one run."""
    code = None
    try:
        main(argv)
    except SystemExit as e:
        code = e.code
    return code, [x for x in capsys.readouterr().out.splitlines() if not x.startswith("TIME:")]


def _pair(files, tmp_path, monkeypatch, capsys, argv, outputs):
    """``argv`` through tpufm's CLI and the port's (``--device cpu``), each
    in a copy of ``files``: [(run, {output: bytes}) of tpufm, of the port]."""
    runs = []
    for name, main, extra in (("jax", jax_cli.main, []), ("torch", torch_cli.main, ["--device", "cpu"])):
        d = tmp_path / name
        shutil.copytree(files, d)
        monkeypatch.chdir(d)
        run = _run(main, [*argv, *extra], capsys)
        runs.append((run, {o: (d / o).read_bytes() for o in outputs if (d / o).exists()}))
    return runs


LOCATE_FORMS = {
    "two-pass": ["--mesh", "8"],
    "two-pass-rc-lut": ["--mesh", "8", "--rc", "--lut", "4"],
    "every-device": ["--mesh", "0", "--fused"],
    "fused": ["--mesh", "8", "--fused"],
    "fused-rc-lut": ["--mesh", "8", "--fused", "--rc", "--lut", "4"],
    "hamming1": ["--mesh", "8", "--mismatches", "1"],
    "hamming2": ["--mesh", "8", "--mismatches", "2", "--seed-hits", "16"],
    "edits1": ["--mesh", "8", "--edits", "1", "--lut", "4"],
    "sam": ["--mesh", "8", "--sam"],
    "sam-m2": ["--mesh", "8", "--sam", "--mismatches", "2"],
    "bam-e1": ["--mesh", "8", "--bam", "--edits", "1"],
    "contigs": ["--mesh", "8", "--fused", "--contigs"],
    "paired": ["--mesh", "8", "--paired", "p_2.qry", "--insert-max", "300"],
    "paired-m1-contigs": ["--mesh", "8", "--paired", "p_2.qry", "--insert-max", "300", "--mismatches", "1",
                          "--contigs"],
    "paired-e1-sam": ["--mesh", "8", "--paired", "p_2.qry", "--insert-max", "300", "--edits", "1", "--sam"],
    "paired-m2-bam": ["--mesh", "8", "--paired", "p_2.qry", "--insert-max", "300", "--mismatches", "2", "--bam"],
}


@pytest.mark.parametrize("form", list(LOCATE_FORMS))
def test_locate_mesh_byte_identical(files, tmp_path, monkeypatch, capsys, form):
    flags = LOCATE_FORMS[form]
    reads = "p_1.qry" if "--paired" in flags else "q.qry"
    n = 40 if "--paired" in flags else B
    argv = ["locate", "g.fa", str(REFSIZE), reads, str(L), str(n), "--k", "2", "--d", "64", "--sample-rate", "8",
            "--max-hits", "6", "--output", "r.out", *flags]
    jax_run, torch_run = _pair(files, tmp_path, monkeypatch, capsys, argv, ("r.out", "r.out.rc"))
    assert torch_run == jax_run
    assert torch_run[0][0] is None and torch_run[1]["r.out"]
    assert ("r.out.rc" in torch_run[1]) == ("--rc" in flags)


def test_locate_mesh_any_length_and_stores(files, tmp_path, monkeypatch, capsys):
    """25 bp reads at k=2 (the locate tables' k=1 index as the search's
    tail) two-pass over 4 shards, with ``--store``; then ``--from-store
    --fused`` by each package from the other's stores."""
    argv = ["locate", "g.fa", str(REFSIZE), "q25.qry", str(L + 1), str(B), "--k", "2", "--d", "64",
            "--sample-rate", "8", "--mesh", "4", "--store", "S", "--output", "r.out"]
    jax_run, torch_run = _pair(files, tmp_path, monkeypatch, capsys, argv, ("r.out",))
    assert torch_run == jax_run and torch_run[0][0] is None
    fused = ["locate", "-", "0", "q25.qry", str(L + 1), str(B), "--mesh", "4", "--fused", "--output", "f.out"]
    for store_of, main, extra in (("jax", torch_cli.main, ["--device", "cpu"]), ("torch", jax_cli.main, [])):
        monkeypatch.chdir(tmp_path / store_of)
        assert _run(main, [*fused, "--from-store", "S", *extra], capsys)[0] is None
        assert (tmp_path / store_of / "f.out").read_bytes() == torch_run[1]["r.out"]


def test_locate_mesh_resume_crossed_with_tpufm(files, tmp_path, monkeypatch, capsys):
    """``locate --fused --mesh 3 --resume``: waves of 39 reads (13 a shard,
    a mesh multiple), the last padded by cycling its reads; killed after one
    wave, the checkpoint is tpufm's byte for byte, and either package
    finishes the other's run with tpufm's files and lines."""
    for cls in (JaxDPSL, DataParallelSearchLocate):
        monkeypatch.setattr(cls, "WAVE_PER_CHIP", 13)
    argv = ["locate", "g.fa", str(REFSIZE), "q.qry", str(L), str(B), "--k", "2", "--d", "64", "--sample-rate", "8",
            "--max-hits", "6", "--lut", "4", "--fused", "--resume", "--mesh", "3", "--output", "r.out"]
    engines = {"jax": JaxDPSL, "torch": DataParallelSearchLocate}
    mains = {"jax": (jax_cli.main, []), "torch": (torch_cli.main, ["--device", "cpu"])}
    want, progress = None, {}
    for crash, finish in ((None, "jax"), ("torch", "torch"), ("torch", "jax"), ("jax", "torch")):
        d = tmp_path / f"run-{crash}-{finish}"
        shutil.copytree(files, d)
        monkeypatch.chdir(d)
        if crash:
            cls = engines[crash]
            real, left = cls.search_locate, [1]

            def crashing(self, *a, **kw):
                if not left[0]:
                    raise RuntimeError("simulated crash")
                left[0] -= 1
                return real(self, *a, **kw)

            main, extra = mains[crash]
            with monkeypatch.context() as m:
                m.setattr(cls, "search_locate", crashing)
                with pytest.raises(RuntimeError, match="simulated crash"):
                    main([*argv, *extra])
            capsys.readouterr()
            progress[crash] = ((d / "r.out.progress").read_bytes(), (d / "r.out.partial").read_bytes())
        main, extra = mains[finish]
        run = _run(main, [*argv, *extra], capsys)
        got = run, (d / "r.out").read_bytes(), sorted(p.name for p in d.iterdir() if "progress" in p.name)
        want = want or got
        assert got == want
    assert progress["torch"] == progress["jax"]
    assert json.loads(progress["torch"][0])["wave"] == 39


ALIGN_FORMS = {
    "fixed": ("fixed", []),
    "fixed-m2-bam": ("fixed", ["--mismatches", "2", "--bam"]),
    "paired-bam": ("r1", ["-2", "R2", "--bam"]),
    "mixed-exact": ("mixed", []),
    "mixed-m2": ("mixed", ["--mismatches", "2"]),
    "mixed-e1": ("mixed", ["--edits", "1"]),
    "mixed-paired": ("mixed1", ["-2", "MATES", "--insert-max", "400"]),
}


@pytest.mark.parametrize("form", list(ALIGN_FORMS))
def test_align_mesh_byte_identical(data, tmp_path, capsys, form):  # noqa: F811 (the fixture imported above)
    reads, extra = ALIGN_FORMS[form]
    extra = [{"R2": data["r2"], "MATES": data["mates"]}.get(x, x) for x in extra]
    common = ["align", data["ref"], data[reads], "--sample-rate", "8", "--max-hits", "6", "--mesh", "8", *extra]
    _both(capsys, [*common, "-o", str(tmp_path / "j.out")],
          [*common, "-o", str(tmp_path / "t.out"), "--device", "cpu"], str(tmp_path / "j.out"), str(tmp_path / "t.out"))
    text = torch_cli.read_sam_or_bam(str(tmp_path / "t.out"))
    assert len([x for x in text.splitlines() if x[0] != "@" and not int(x.split("\t")[1]) & 4]) >= 20


#: the fields of a locate record that depend on the clock
TIMED = {"value", "vs_baseline", "scaling_efficiency", "positions_per_s_one_chip", "positions_per_s_per_chip",
         "seconds_per_pass", "pass_seconds", "seconds_per_pass_median", "one_device_pass_seconds", "build_seconds"}


def test_bench_locate_mesh_record_matches_tpufm(capsys):
    """``bench --locate --mesh 8``: tpufm's metric, unit and fields, equal
    but for the times; the port's adds its device fields."""
    argv = ["bench", "--locate", "--refsize", "20000", "--numqueries", "4099", "--d", "64", "--sample-rate", "8",
            "--iterations", "1", "--mesh", "8"]
    jax_cli.main(argv)
    want = json.loads(capsys.readouterr().out.splitlines()[-1])
    torch_cli.main([*argv, "--device", "cpu"])
    got = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert got["metric"] == want["metric"] and got["unit"] == want["unit"] and "4096 rows" in got["metric"]
    assert [f for f in got["detail"] if f in want["detail"]] == list(want["detail"])
    for field, value in want["detail"].items():
        if field not in TIMED:
            assert got["detail"][field] == value, field
    assert got["detail"]["devices"] == 8 and got["detail"]["bit_exact_vs_oracle"] is True
    assert got["detail"]["device"] == "cpu" and len(got["detail"]["one_device_pass_seconds"]) == 1
