"""``python -m tpufm_torch.cli search --device cpu`` against ``tpufm search``
on the same index and query files: the .res files must be byte-identical
(intervals are integers; tolerance 0)."""

import numpy as np
import pytest
import torch

from tpufm import cli as jax_cli
from tpufm.index.formats import read_fmi, save_npz
from tpufm.io.fasta import write_reference
from tpufm.io.genreads import generate_reads, write_reads_fasta
from tpufm.utils.encoding import decode_bases
from tpufm_torch import cli as torch_cli


@pytest.fixture
def fmi(tmp_path, rng):
    n = 3000
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    ref = tmp_path / "ref.fa"
    write_reference(ref, decode_bases(codes))
    path = tmp_path / "ref.fmi"
    jax_cli.main(["build", str(ref), str(n), "--k", "2", "--d", "64", "--output", str(path)])
    return codes, path


def _qry(tmp_path, codes, L, n, seed):
    path = tmp_path / f"reads{L}.qry"
    reads, starts = generate_reads(codes, L, n, seed=seed, return_starts=True)
    write_reads_fasta(path, reads, starts)
    return path


@pytest.mark.parametrize("fmt,lut", [("fmi", 0), ("fmi", 4), ("npz", 0)])
def test_res_byte_identical(tmp_path, fmi, capsys, fmt, lut):
    codes, path = fmi
    if fmt == "npz":
        index, _ = read_fmi(path)
        path = tmp_path / "ref.npz"
        save_npz(path, index)
    qry = _qry(tmp_path, codes, 24, 64, seed=3)
    args = ["search", str(path), str(qry), "24", "64", "--iterations", "1", "--lut", str(lut)]
    jax_cli.main(args + ["--output", str(tmp_path / "jax.res")])
    run = torch_cli.main(args + ["--device", "cpu", "--output", str(tmp_path / "torch.res")])
    assert (tmp_path / "torch.res").read_bytes() == (tmp_path / "jax.res").read_bytes()
    assert capsys.readouterr().out.count("TIME: \t ") == 2
    if lut:  # tpufm search left <index>.lut4.npz; the port loaded it
        assert run.engine.lut_build_seconds is None


def test_any_length_both_strands_byte_identical(tmp_path, fmi):
    codes, path = fmi
    qry = _qry(tmp_path, codes, 25, 48, seed=5)  # 25 % 2: one k=1 tail round
    args = ["search", str(path), str(qry), "25", "48", "--iterations", "1", "--rc"]
    jax_cli.main(args)
    run = torch_cli.main(args + ["--device", "cpu"])
    for suffix in ("", ".rc"):
        ours = path.parent / f"{path.name}.res.cpu{suffix}"
        assert ours.read_bytes() == (path.parent / f"{path.name}.res.tpu{suffix}").read_bytes()
    assert run.results.shape == (96, 2)
    assert (run.results[:48, 1] > run.results[:48, 0]).all()


def test_cli_argument_errors(tmp_path, fmi):
    codes, path = fmi
    qry = _qry(tmp_path, codes, 24, 8, seed=1)
    with pytest.raises(SystemExit):
        torch_cli.main(["search", str(path), str(qry), "24", "8", "--iterations", "0"])
    if torch.cuda.is_available():
        return
    # the default device is cuda, with no fallback to the CPU
    with pytest.raises(RuntimeError, match="cuda"):
        torch_cli.main(["search", str(path), str(qry), "24", "8"])


@pytest.mark.parametrize("lut", [0, 4])
def test_engine_pallas_res_byte_identical(tmp_path, fmi, lut):
    codes, path = fmi
    qry = _qry(tmp_path, codes, 24, 64, seed=7)
    args = ["search", str(path), str(qry), "24", "64", "--iterations", "1",
            "--lut", str(lut), "--engine", "pallas"]
    jax_cli.main(args + ["--output", str(tmp_path / "jax.res")])
    run = torch_cli.main(args + ["--device", "cpu", "--output", str(tmp_path / "torch.res")])
    assert (tmp_path / "torch.res").read_bytes() == (tmp_path / "jax.res").read_bytes()
    assert (run.results[:, 1] > run.results[:, 0]).all()


def test_engine_pallas_refuses_a_tail(tmp_path, fmi):
    codes, path = fmi
    qry = _qry(tmp_path, codes, 25, 8, seed=9)  # 25 % 2: needs the k=1 tail
    args = ["search", str(path), str(qry), "25", "8", "--engine", "pallas"]
    with pytest.raises(SystemExit) as jax_exit:
        jax_cli.main(args)
    with pytest.raises(SystemExit) as torch_exit:
        torch_cli.main(args + ["--device", "cpu"])
    assert "pad reads to a multiple of k for pallas" in str(torch_exit.value.code)
    assert torch_exit.value.code == jax_exit.value.code
