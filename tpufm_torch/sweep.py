"""The experiment sweep on one device: the (refsize x k x d x engine x
lut_m) matrix in one process, one JSON record a configuration.

Counterpart of tpufm/sweep.py (``SWEEP_ENGINES`` :21, ``_make_engine`` :24,
``run_sweep`` :43), which stands in for the reference's cluster script
matrix: the same seeds, the same matrix and skips, the same record keys,
each engine a ``SearchEngine`` of its layout on one torch device (cuda
unless the caller asks for the CPU; no fallback). Each record adds
``device`` (the card's name, or "cpu") and ``power_limit_w``, as the bench
records do. ``seconds_per_pass`` is the mean of ``iterations`` passes of
``search_device`` on reads already on the device, each ending at a device
barrier, after one warm-up pass; ``bit_exact`` holds 4,096 sampled reads
(all of them below that) against the numpy oracle, the paired layout's
after its repair (``search``).
"""

from __future__ import annotations

import itertools
import json
import time

import numpy as np
import torch

from tpufm_torch.bench import power_limit_w
from tpufm_torch.device import resolve_device
from tpufm_torch.engine.lf_round import lf_round_indexed
from tpufm_torch.engine.search import SearchEngine
from tpufm_torch.host.index import IndexConfig, build_index
from tpufm_torch.host.layouts import make_alt_counters
from tpufm_torch.host.oracle import search_oracle
from tpufm_torch.host.seqio import generate_reads
from tpufm_torch.timer import timed_device_passes

#: engines run_sweep can dispatch (unknown names raise: a mistyped engine
#: must never produce records labelled with another engine)
SWEEP_ENGINES = ("xla", "xla-split", "xla-ac", "xla-paired", "pallas")


def _make_engine(engine: str, index, lut_m: int, device) -> SearchEngine | None:
    """The engine of a sweep row, or None for a combination that does not
    exist (the alternate counters take no LUT, the paired layout needs one);
    raises on unknown names."""
    if engine in ("xla", "pallas"):
        return SearchEngine(index, device, lut_m=lut_m)
    if engine == "xla-split":
        return SearchEngine(index, device, layout="split", lut_m=lut_m)
    if engine == "xla-paired":
        return SearchEngine(index, device, layout="paired", lut_m=lut_m) if lut_m else None
    if engine == "xla-ac":
        return SearchEngine(make_alt_counters(index), device) if lut_m == 0 else None
    raise ValueError(f"unknown engine {engine!r}; known: {SWEEP_ENGINES}")


def run_sweep(
    refsizes=(1_000_000,),
    ks=(1, 2),
    ds=(64,),
    engines=("xla",),
    lut_ms=(0,),
    num_queries: int = 65536,
    query_len: int = 120,
    iterations: int = 3,
    seed: int = 0,
    out_path: str | None = None,
    verify: bool = True,
    device: str | torch.device = "cuda",
) -> list:
    """Run the (refsize x k x d x engine x lut_m) matrix on ``device``;
    returns the records, each printed as a JSON line and appended to
    ``out_path`` when given."""
    for engine in engines:  # the whole matrix, before any work
        if engine not in SWEEP_ENGINES:
            raise ValueError(f"unknown engine {engine!r}; known: {SWEEP_ENGINES}")
    dev = resolve_device(device)
    named = {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "power_limit_w": power_limit_w(dev),
    }
    records = []
    rng = np.random.default_rng(seed)
    fh = open(out_path, "a") if out_path else None
    for refsize in refsizes:
        codes = rng.integers(0, 4, size=refsize, dtype=np.uint8)
        queries = generate_reads(codes, query_len, num_queries, seed=seed + 1)
        qd = torch.from_numpy(np.require(queries, np.uint8, ["C", "W"])).to(dev)
        for k, d in itertools.product(ks, ds):
            if query_len % k:
                continue
            t0 = time.perf_counter()
            # one build per (refsize, k, d), shared by the engines
            index = build_index(codes, IndexConfig(k=k, d=d))
            build_s = time.perf_counter() - t0
            for engine, lut_m in itertools.product(engines, lut_ms):
                if lut_m and (lut_m % k or (query_len - lut_m) % k):
                    continue
                eng = _make_engine(engine, index, lut_m, dev)
                if eng is None:
                    continue
                step = lf_round_indexed if engine == "pallas" else None
                dt, _, _ = timed_device_passes(lambda: eng.search_device(qd, step), iterations=iterations)
                out = eng.search_device(qd, step)
                exact = None
                if verify:
                    # repaired intervals come only from search; a uniform
                    # sample of >= 4K reads, as the bench's
                    host = eng.search(queries) if engine == "xla-paired" else out.cpu().numpy().astype(np.uint32)
                    n_v = min(num_queries, 4096)
                    vidx = np.sort(np.random.default_rng(seed + 2).choice(num_queries, n_v, replace=False))
                    exact = bool((host[vidx] == search_oracle(index, queries[vidx])).all())
                rec = {
                    "refsize": refsize,
                    "k": k,
                    "d": d,
                    "engine": engine,
                    "lut_m": lut_m,
                    "num_queries": num_queries,
                    "query_len": query_len,
                    "build_s": round(build_s, 2),
                    "seconds_per_pass": dt,
                    "reads_per_s": round(num_queries / dt),
                    "steps_per_s": round(num_queries * (query_len // k) / dt),
                    "bit_exact": exact,
                    **named,
                }
                records.append(rec)
                line = json.dumps(rec)
                print(line, flush=True)
                if fh:
                    fh.write(line + "\n")
                    fh.flush()
                del eng, out
    if fh:
        fh.close()
    return records
