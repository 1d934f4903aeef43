"""BENCHMARK.json, and every configuration, mix, entry and metric it names,
found by name."""

import json
import re

import pytest

from fmbench import registry

BENCH = registry.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "fmbench/run.py"]
    assert BENCH["paths"] == ["fmbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_is_found_by_name(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    cell = registry.cell(BENCH, w["name"])
    config = registry.config(BENCH, cell["config"])
    traffic = registry.traffic(cell["traffic"])
    entry = registry.entry(traffic["entry"])
    for fn in ("build", "call", "expected", "control", "compare"):
        assert callable(getattr(entry, fn))
    assert config["name"] == cell["config"]
    assert {"text_bases", "k", "d", "lut_m", "source", "reduced", "assumed"} <= set(config)
    e2e = registry.metrics(BENCH, w["name"], traced=False)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert registry.metrics(BENCH, w["name"], traced=True)


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_each_configuration_file(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert c["file"].startswith("fmbench/configs/")
    config = json.loads((registry.ROOT / c["file"]).read_text())
    assert config["reduced"] == c["reduced"]
    assert c["source"].startswith("https://")


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_each_metric_has_a_reader(m):
    assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
    assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
    assert callable(registry.metric(m["name"]))
    for w in m.get("workloads", []):
        registry.cell(BENCH, w)
    if "bound" in m:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    else:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_each_cell_a_per_layer_metric_lists_reports_what_it_moves(m):
    for w in m["workloads"]:
        assert m["moves"] in {e["name"] for e in registry.metrics(BENCH, w, traced=False)}
        assert m in registry.metrics(BENCH, w, traced=True)


def test_names_are_unique():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(BENCH["workloads"])


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        registry.cell(BENCH, "no.such_cell")
    with pytest.raises(KeyError):
        registry.config(BENCH, "no_such_config")
    with pytest.raises(FileNotFoundError):
        registry.traffic("no_such_mix")
    with pytest.raises(FileNotFoundError):
        registry.metric("no_such_metric")
