"""The port's sweep (tpufm_torch.sweep, ``python -m tpufm_torch.cli sweep``)
on the CPU against tpufm's (tpufm.sweep, ``tpufm sweep``) on the same
seeds and matrix: the same rows in the same order, tpufm's keys (plus the
port's ``device`` and ``power_limit_w``), every time-free field equal and
every row bit-exact against the oracle; and the ``SWEEP FAILED`` exit."""

import json

import numpy as np
import pytest

from tpufm import sweep as jax_sweep
from tpufm_torch import cli as torch_cli
from tpufm_torch import sweep

#: a small matrix: every engine, with and without a LUT, two k, two d
MATRIX = dict(refsizes=(20_000,), ks=(1, 3), ds=(64, 128), engines=sweep.SWEEP_ENGINES, lut_ms=(0, 3),
              num_queries=256, query_len=24, iterations=1)
#: the fields a row's times do not change
FIELDS = ("refsize", "k", "d", "engine", "lut_m", "num_queries", "query_len", "bit_exact")


def test_sweep_engines_equal_tpufm():
    assert sweep.SWEEP_ENGINES == jax_sweep.SWEEP_ENGINES


def test_sweep_rows_equal_tpufm(tmp_path, capsys):
    want = jax_sweep.run_sweep(**MATRIX, out_path=str(tmp_path / "jax.jsonl"))
    capsys.readouterr()
    got = sweep.run_sweep(**MATRIX, out_path=str(tmp_path / "torch.jsonl"), device="cpu")
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert printed == got == [json.loads(x) for x in (tmp_path / "torch.jsonl").read_text().splitlines()]
    # no LUT for the alternate counters, none missing for the paired layout
    assert len(got) == len(want) == 2 * 2 * (2 + 2 + 1 + 1 + 2)
    for g, w in zip(got, want):
        assert set(g) == set(w) | {"device", "power_limit_w"}
        assert {f: g[f] for f in FIELDS} == {f: w[f] for f in FIELDS}
        assert g["bit_exact"] is True and g["device"] == "cpu" and g["power_limit_w"] is None
        assert g["seconds_per_pass"] > 0 and g["reads_per_s"] == round(256 / g["seconds_per_pass"])


def test_sweep_refuses_an_unknown_engine_first():
    for run in (jax_sweep.run_sweep, lambda **kw: sweep.run_sweep(**kw, device="cpu")):
        with pytest.raises(ValueError, match="unknown engine 'xla-tiled'; known: "):
            run(refsizes=(1000,), engines=("xla", "xla-tiled"))


def test_sweep_cli_prints_rows_and_fails_on_a_wrong_row(tmp_path, capsys, monkeypatch):
    argv = ["sweep", "--refsizes", "5000", "--ks", "2", "--ds", "64", "--engines", "xla-ac", "xla-paired",
            "--luts", "0", "4", "--numqueries", "64", "--length", "24", "--iterations", "1", "--device", "cpu"]
    rows = torch_cli.main(argv)
    assert [json.loads(x) for x in capsys.readouterr().out.splitlines()] == rows
    assert [(r["engine"], r["lut_m"]) for r in rows] == [("xla-ac", 0), ("xla-paired", 4)]
    monkeypatch.setattr(sweep, "search_oracle", lambda index, q: np.zeros((q.shape[0], 2), np.uint32))
    with pytest.raises(SystemExit) as exit_info:
        torch_cli.main(argv)
    assert str(exit_info.value.code).startswith("SWEEP FAILED: 2/2 rows not bit-exact vs oracle (first: {")
