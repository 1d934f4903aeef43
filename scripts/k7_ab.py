"""K7 of this checkout against an earlier K7 on one card, in turns.

    python3 scripts/k7_ab.py OLD_build_tables.cu [NEW.cu ...] [--rounds R]

OLD is a ``tpufm_torch/csrc/build_tables.cu`` from before K7 took a slice
of the suffix array: its launcher is ``tpufm_build_tables(words, n, sa, k,
nb, bitmaps, counts, dollar_pos, stream)``. NEW, the checkout's
``csrc/build_tables.cu`` unless other sources of its launcher's signature
are given, takes (words, n, sa, rows, p0, k, nb, ...). Each is built with
nvcc (``kernels.compile_libraries``, into ``tpufm_torch/_build/``), and
ptxas's register count of each K7 instance printed. On the two
texts of ``chip_smoke.py`` phase 16 (10 Mbase at each k of ``--ks``,
default 3, and the 250 Mbase genome record's at k=3; d=192; each sorted
on the card), the text is packed once and
each K7 launched alone on the same inputs, the whole array (p0 = 0, rows =
n + 1): outputs held equal, then timed in turns, old, new, new, old, R
times (each time ``chip_smoke.graph_ms``: a CUDA graph of 20 launches,
median of 7 replays). Prints the card's name and power limit, then one
JSON line of every time. Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from tpufm_torch import bench, kernels  # noqa: E402
from tpufm_torch.index.builder_device import pack_text_2bit  # noqa: E402
from tpufm_torch.index.sa_device import suffix_array_device_arr, upload_text  # noqa: E402

D = 192


def registers(log: str) -> dict:
    """{K: registers} of each K7 instance, from ``nvcc -Xptxas -v``."""
    out, k = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"build_tables_kernelILi(\d+)E", line)
            k = None if m is None else int(m.group(1))
        elif k is not None and (m := re.search(r"Used (\d+) registers", line)):
            out[k] = int(m.group(1))
    return out


def launchers(old: Path, new: list) -> dict:
    """{label: (launch, registers)}: each launch fn(words, n, sa, k,
    bitmaps, counts, dollar_pos) runs its K7 on the current stream, the
    whole array."""
    import ctypes

    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    jobs = [([old], "libtpufm_k7_old")] + [([src], f"libtpufm_k7_new{i}") for i, src in enumerate(new)]
    libs = kernels.compile_libraries(kernels._nvcc(), kernels.NVCC_FLAGS, jobs)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    out = {}
    for (srcs, _), path in zip(jobs, libs):
        lib = ctypes.CDLL(str(path))
        is_old = srcs[0] == old
        lib.tpufm_build_tables.argtypes = [P, LL, P, I, I, P, P, P, P] if is_old else [P, LL, P, LL, LL, I, I, P,
                                                                                          P, P, P]

        def run(words, n, sa, k, bm, counts, dpos, lib=lib, is_old=is_old):
            slice_args = () if is_old else (n + 1, 0)
            err = lib.tpufm_build_tables(words.data_ptr(), n, sa.data_ptr(), *slice_args, k, D // 32, bm.data_ptr(),
                                         counts.data_ptr(), dpos.data_ptr(), stream())
            if err:
                raise RuntimeError(f"K7 of {srcs[0]} failed to launch: cudaError {err}")

        out["old" if is_old else str(srcs[0])] = (run, registers(path.with_suffix(".log").read_text()))
    return out


def case(text: tuple, k: int, runs: dict, rounds: int) -> dict:
    words, n, sa = text
    dev = sa.device
    E = -(-(n + 1) // D)
    outs = {}
    for name, (run, _) in runs.items():
        bm = torch.zeros((E + 1, k, 2, D // 32), dtype=torch.int32, device=dev)
        counts = torch.zeros((E, 4**k), dtype=torch.int32, device=dev)
        dpos = torch.zeros(k, dtype=torch.int64, device=dev)
        run(words, n, sa, k, bm, counts, dpos)
        outs[name] = (bm, counts, dpos)
    torch.cuda.synchronize()
    for name, out in outs.items():
        if not all(torch.equal(a, b) for a, b in zip(out, outs["old"])):
            raise AssertionError(f"{n} bases: K7 of {name} differs from the old one")
    times = {name: [] for name in runs}
    for _ in range(rounds):
        for new in (name for name in runs if name != "old"):
            for name in ("old", new, new, "old"):
                run = runs[name][0]
                times[name].append(chip_smoke.graph_ms(lambda: run(words, n, sa, k, *outs[name])))
    return {"bases": n, "k": k, "d": D, "ms": times,
            "median_ms": {name: statistics.median(t) for name, t in times.items()}}


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("old", type=Path)
    p.add_argument("new", type=Path, nargs="*", default=[kernels.CSRC_DIR / "build_tables.cu"])
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--ks", type=int, nargs="+", default=[3])
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("k7_ab: needs a GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    runs = launchers(args.old, args.new)
    dev = torch.device("cuda", 0)

    def text(codes: np.ndarray) -> tuple:
        cd = upload_text(codes, dev)
        return pack_text_2bit(cd), codes.shape[0], suffix_array_device_arr(cd)

    ten = text(np.random.default_rng(chip_smoke.SEED).integers(0, 4, chip_smoke.REF_BASES, dtype=np.uint8))
    cases = [case(ten, k, runs, args.rounds) for k in args.ks]
    del ten
    cases.append(case(text(bench._reference_codes(chip_smoke.GENOME_BASES, 0)[1]), 3, runs, args.rounds))
    print(json.dumps({"registers": {name: regs for name, (_, regs) in runs.items()}, "k7_ab": cases}))


if __name__ == "__main__":
    main()
