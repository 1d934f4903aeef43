"""Everything a cell needs, found by name.

A cell is a ``workloads`` entry of BENCHMARK.json. Its configuration is the
file that BENCHMARK.json's ``configs`` entry names, its traffic mix
``traffic/<traffic>.json``, the call into the program that the mix drives
``entries/<entry>.py``, and each metric ``metrics/<name>.py`` (a module with
``read(run)``). A new cell, mix, entry or metric is a new file and a new
entry in BENCHMARK.json; no file here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def entry(name: str):
    return importlib.import_module(f"fmbench.entries.{name}")


def metric(name: str):
    """The reader of metric ``name``: ``read(run) -> float | None``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"fmbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _applies(m: dict, cell_name: str, reported: set) -> bool:
    if "workloads" in m:
        return cell_name in m["workloads"]
    return m.get("moves", m["name"]) in reported


def metrics(bench: dict, cell_name: str, traced: bool) -> list[dict]:
    """The cell's end-to-end metrics, or with ``traced`` its per-layer
    ones: each that lists the cell, or, without a list, each end-to-end
    metric and each per-layer metric whose ``moves`` the cell reports."""
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or cell_name in m["workloads"]]
    if not traced:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"] if _applies(m, cell_name, reported)]
