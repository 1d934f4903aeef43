"""Suffix array of a 2-bit text plus its sentinel (host side).

Counterpart of tpufm/index/suffix_array.py. Four methods:

* ``native``: SA-IS in C++ (tpufm_torch/csrc/sais.cpp), compiled at first
  use with the host C++ compiler (``$CXX``, else ``g++``) into
  tpufm_torch/_build/ and bound with ctypes. O(n); for real references.
* ``doubling``: numpy prefix doubling, O(n log^2 n); for small texts and as
  the cross-check.
* ``device``: prefix doubling on a torch device
  (tpufm_torch/index/sa_device.py), ``device`` cuda unless asked for the
  CPU (tpufm's ``method="device"``, tpufm/index/suffix_array.py:152).
* ``sharded``: prefix doubling over ``make_mesh(device=device)``, every
  card or one CPU shard (tpufm_torch/index/sa_sharded.py; tpufm's
  ``method="sharded"``, :156).

There is no silent fallback between them: a native library that cannot be
built raises. For codes of length n the result has n+1 entries and
result[0] == n (the sentinel '$' is the smallest symbol).
"""

from __future__ import annotations

import ctypes

import numpy as np

from tpufm_torch.kernels import host_library

_sais = None


def _library() -> ctypes.CDLL:
    """The SA-IS library, compiled on first call unless a build of the
    current source and flags exists."""
    global _sais
    if _sais is None:
        _sais = host_library("sais.cpp", "libsais")
        _sais.tpufm_sais_u8.restype = ctypes.c_int
        _sais.tpufm_sais_u8.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    return _sais


def suffix_array_native(codes: np.ndarray) -> np.ndarray:
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    sa = np.empty(codes.shape[0] + 1, dtype=np.int64)
    rc = _library().tpufm_sais_u8(codes.ctypes.data, codes.shape[0], sa.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"tpufm_sais_u8 failed with code {rc}")
    return sa


def suffix_array_doubling(codes: np.ndarray) -> np.ndarray:
    """Prefix doubling (Manber-Myers) with numpy lexsort rounds."""
    codes = np.asarray(codes)
    n = codes.shape[0]
    big = n + 1
    rank = np.empty(big, dtype=np.int64)
    rank[:n] = codes.astype(np.int64) + 1  # the sentinel 0 is strictly smallest
    rank[n] = 0
    order = np.argsort(rank, kind="stable")
    sorted_r = rank[order]
    rank = np.empty(big, dtype=np.int64)
    rank[order] = np.concatenate(([0], np.cumsum(sorted_r[1:] != sorted_r[:-1])))
    h = 1
    while rank[order[-1]] < big - 1:
        second = np.full(big, -1, dtype=np.int64)
        second[: big - h] = rank[h:]
        order = np.lexsort((second, rank))
        r1, r2 = rank[order], second[order]
        changed = (r1[1:] != r1[:-1]) | (r2[1:] != r2[:-1])
        rank = np.empty(big, dtype=np.int64)
        rank[order] = np.concatenate(([0], np.cumsum(changed)))
        h *= 2
    sa = np.empty(big, dtype=np.int64)
    sa[rank] = np.arange(big, dtype=np.int64)
    return sa


def suffix_array(codes: np.ndarray, method: str = "native", device="cuda") -> np.ndarray:
    """int64 [n+1] suffix array of ``codes`` + sentinel; method is
    ``native``, ``doubling``, ``device`` (sorted on ``device``) or
    ``sharded`` (sorted over every card, or one CPU shard)."""
    if method == "native":
        return suffix_array_native(codes)
    if method == "doubling":
        return suffix_array_doubling(codes)
    if method == "device":
        from tpufm_torch.index.sa_device import suffix_array_device

        return suffix_array_device(codes, device)
    if method == "sharded":
        from tpufm_torch.index.sa_sharded import suffix_array_sharded

        return suffix_array_sharded(codes, device=device)
    raise ValueError(f"unknown suffix array method {method!r} (native, doubling, device or sharded)")
