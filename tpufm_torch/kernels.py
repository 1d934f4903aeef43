"""Build and load the port's CUDA kernels.

Each .cu source in tpufm_torch/csrc/ compiles at first use with nvcc for
Hopper (sm_90a) into its own shared library with a plain C interface, all
sources at once (one nvcc process each), placed in tpufm_torch/_build/ under
a name that hashes the source and flags, and bound with ctypes.
``compile_libraries`` also builds the host side's C++ (csrc/sais.cpp).
Nothing compiles when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

#: argument types of each exported launcher, by source: c_void_p for every
#: pointer and the stream (ctypes would cut a pointer passed as an int)
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES = {
    "lf_round": {
        # entries, nrows, row_words, k, nb, iv, code, dollar, out, n, stream
        "tpufm_lf_round": [_P, _LL, _I, _I, _I, _P, _P, _P, _P, _LL, _P],
        # rows, row_words, k, nb, iv, code, dollar, out, n, stream
        "tpufm_lf_round_rows": [_P, _I, _I, _I, _P, _P, _P, _P, _LL, _P],
        # entries, nrows, row_words, k, nb, iv, code, dollar, out, n reads, stream
        "tpufm_lf_round_pairs": [_P, _LL, _I, _I, _I, _P, _P, _P, _P, _LL, _P],
    },
    "row_gather": {
        # table, nrows, row_words, idx, out, n, path, tile_rows, blocks, stream
        "tpufm_row_gather": [_P, _LL, _I, _P, _P, _LL, _I, _I, _I, _P],
    },
    "locate_walk": {
        # rows, nrows, row_words, nb, samples, n_samples, dollar, p, out, n,
        # sample_rate, next_lane, stream
        "tpufm_locate_walk": [_P, _LL, _I, _I, _P, _LL, _P, _P, _P, _LL, _I, _P, _P],
    },
    "hamming_verify": {
        # text, nw, pos, qwords, valid, out, n, C, W, L, stream
        "tpufm_hamming_verify": [_P, _LL, _P, _P, _P, _P, _LL, _LL, _I, _I, _P],
    },
    "myers_verify": {
        # text, nw, n_text, peq, lo, hi, valid, dist, start, n, C, W, L, E,
        # scratch, slots, stream
        "tpufm_myers_verify": [_P, _LL, _LL, _P, _P, _P, _P, _P, _P, _LL, _LL, _I, _I, _I, _P, _LL, _P],
        # n -> the scratch slots K6 needs
        "tpufm_myers_verify_slots": [_LL],
    },
}
#: launchers that return something other than a cudaError_t (c_int)
RESTYPES = {"tpufm_myers_verify_slots": _LL}

_libraries: dict[str, ctypes.CDLL] = {}


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def headers() -> list[Path]:
    """The shared headers (csrc/*.cuh): every CUDA library's build hash
    covers them, so a changed header rebuilds each source that includes it."""
    return sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError(
            "no CUDA toolkit found (set CUDA_HOME or put nvcc on PATH): "
            "the port's kernels are built with nvcc at first use"
        )
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def compile_libraries(compiler: str, flags: list[str], jobs: list[tuple[list[Path], str]],
                      deps: list[Path] = ()) -> list[Path]:
    """Compile each job (sources, stem) into ``_build/<stem>_<hash of
    sources, deps and flags>.so`` unless that library exists, one compiler
    process per job, all running at once; return the paths. ``deps`` are
    files every job includes (headers), hashed but not passed to the
    compiler. The compiler's output is kept beside each library as
    ``<name>.log``. Raises RuntimeError if a compiler fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs, running = [], []
    for srcs, stem in jobs:
        h = hashlib.sha256(" ".join(flags).encode())
        for src in [*srcs, *deps]:
            h.update(src.name.encode())
            h.update(src.read_bytes())
        lib = BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"
        libs.append(lib)
        if not lib.exists():
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [compiler, *flags, "-o", str(tmp), *map(str, srcs)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            running.append((proc, srcs, lib, tmp))
    failed = []
    for proc, srcs, lib, tmp in running:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{compiler} failed ({proc.returncode}) on {[s.name for s in srcs]}:\n{log}")
            continue
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def build() -> dict[str, Path]:
    """The CUDA kernel libraries by source name (``lf_round``, ...), each
    compiled with nvcc unless already built; each log holds ptxas's register
    and spill counts."""
    srcs = sources()
    libs = compile_libraries(_nvcc(), NVCC_FLAGS, [([s], f"libtpufm_{s.stem}") for s in srcs],
                             deps=headers())
    return {s.stem: lib for s, lib in zip(srcs, libs)}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu (every kernel library is built
    on the first call), with the argument types of its launchers declared."""
    if not _libraries:
        for stem, path in build().items():
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in SIGNATURES[stem].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = RESTYPES.get(fn, ctypes.c_int)
            lib.tpufm_cuda_error_string.argtypes = [ctypes.c_int]
            lib.tpufm_cuda_error_string.restype = ctypes.c_char_p
            _libraries[stem] = lib
    return _libraries[name]


def error_string(name: str, err: int) -> str:
    return f"{library(name).tpufm_cuda_error_string(err).decode()} (cudaError {err})"
