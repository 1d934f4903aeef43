"""The A/B machinery of the kernel scripts (``k89_ab.py``, ``k1p_ab.py``):
a kernel library built from an earlier source and from the checkout's, side
by side; ptxas's registers of each kernel instance; the two builds'
launchers held equal to each other and to the plain version, then timed in
turns (old, new, new, old) with ``chip_smoke.graph_ms``. Needs a GPU.
"""

from __future__ import annotations

import ctypes
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from tpufm_torch import kernels  # noqa: E402

ORDER = ("old", "new")


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def registers(log: str, label) -> dict:
    """{instance: "R registers, S B spill stores"} of the kernel instances
    of an ``nvcc -Xptxas -v`` log that ``label(line)`` names (from ptxas's
    "Compiling entry function" line; None skips the instance)."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = label(line)
        elif name and (m := re.search(r"(\d+) bytes spill stores", line)):
            out[name] = out.get(name, "") + f", {m.group(1)} B spill stores"
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out[name] = f"{m.group(1)} registers" + out.get(name, "")
    return out


def builds(old: Path, source: str, label) -> dict:
    """{"old": (ctypes library, registers), "new": ...}: ``old`` (a
    ``csrc/<source>.cu`` of an earlier tree, beside its own headers, from
    which its includes resolve) and the checkout's ``csrc/<source>.cu``,
    compiled at once with nvcc into ``tpufm_torch/_build/``, their
    launchers typed as ``kernels.SIGNATURES[source]``; registers of the
    instances ``label`` names (``registers``)."""
    new = kernels.CSRC_DIR / f"{source}.cu"
    deps = sorted(old.parent.glob("*.cuh")) + kernels.headers()
    paths = kernels.compile_libraries(kernels._nvcc(), kernels.NVCC_FLAGS,
                                      [([old], f"libtpufm_ab_{source}_old"), ([new], f"libtpufm_ab_{source}_new")],
                                      deps)
    out = {}
    for name, path in zip(ORDER, paths):
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in kernels.SIGNATURES[source].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        out[name] = (lib, registers(path.with_suffix(".log").read_text(), label))
    return out


def runner(lib, fn: str, call: tuple):
    """A launch of ``fn`` of ``lib`` with the arguments ``call`` on the
    current stream; raises if it fails to launch."""
    def run():
        err = getattr(lib, fn)(*call, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{fn} failed to launch: cudaError {err}")

    return run


def _parts(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def in_turns(label: str, runs: dict, plain, bound_bytes: int, rounds: int, **info) -> dict:
    """``runs`` ({"old": (run, out), "new": ...}, each ``out`` a tensor or a
    tuple of tensors that ``run`` writes) run once, every output held equal
    to old's and to ``plain`` (every word), then timed in turns, old, new,
    new, old, ``rounds`` times (``chip_smoke.graph_ms`` each), beside the
    bound of ``bound_bytes``. Prints a line; returns the row."""
    for run, _ in runs.values():
        run()
    torch.cuda.synchronize()
    want = _parts(runs["old"][1])
    for name, (_, out) in runs.items():
        for got, ref in zip(_parts(out), want):
            if not torch.equal(got, ref):
                raise AssertionError(f"{label}: {name} differs from old in {int((got != ref).sum())} words")
    if not all(torch.equal(p, w) for p, w in zip(_parts(plain), want)):
        raise AssertionError(f"{label}: the builds differ from the plain version")
    times = {name: [] for name in runs}
    for _ in range(rounds):
        for name in ORDER + ORDER[::-1]:
            times[name].append(chip_smoke.graph_ms(runs[name][0]))
    bound = chip_smoke.bound_ms(bound_bytes)
    med = {name: statistics.median(t) for name, t in times.items()}
    row = {"case": label, **info, "bound_ms": bound, "ms": times, "median_ms": med,
           "spread_ms": {name: max(t) - min(t) for name, t in times.items()},
           "share": {name: bound / m for name, m in med.items()}}
    print(f"{label}: bound {bound:.4f} ms; " + "; ".join(
        f"{name} {med[name]:.4f} ms ({min(times[name]):.4f}-{max(times[name]):.4f}, {bound / med[name] * 100:.1f}%)"
        for name in ORDER), flush=True)
    return row


def replay(fn, tables: tuple, dollar, iv, codes, keep: tuple, k: int, d: int) -> dict:
    """The (iv, code) entering the rounds ``keep`` of the rounds ``codes``
    from ``iv``, each round through ``fn`` (a plain version; of a tuple it
    returns, the first part is the next interval)."""
    kept = {}
    for j, code in enumerate(codes, start=1):
        if j in keep:
            kept[j] = (iv, code)
        iv = _parts(fn(*tables, iv, code, dollar, k, d))[0]
    return kept
