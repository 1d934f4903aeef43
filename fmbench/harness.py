"""One run of one cell: set-up, the measured window, the check of outputs
against the plain reference, and the result line.

Set-up makes the text and a pool of distinct batches from the seed, has the
program build its index on the device, and warms the cell's one batch shape
until a batch's time settles. The window is a closed loop: one client sends
the pool's batches in turn, each as soon as the last one's host result is
back, and times each from its send to its host result. A batch still running
when the window closes counts outside it. Inside the window the harness
allocates nothing per batch, writes nothing and keeps the garbage collector
off. Of each pool batch one answer, drawn from the seed among those it got in
the window, is kept and compared with the reference once the window has
closed and the program's state is freed.
"""

from __future__ import annotations

import contextlib
import gc
import subprocess
import sys
import time

import numpy as np
import torch

from fmbench import gen, trace
from fmbench.derive import Run
from fmbench.reference import SuffixOrder

#: torch's host threads: the timed path does no parallel host compute
HOST_THREADS = 1
#: top-level module names that no run may load
BANNED = frozenset({"jax", "jaxlib", "flax", "tpufm"})
#: most batches a window holds
MAX_BATCHES = 1 << 16
#: warm-up settles when two batches in a row take within this share of each other
SETTLE = 0.05


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is banned."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & BANNED)


def warm_up(call, pool: list):
    """Every pool batch once, then batches in turn until two in a row take
    within ``SETTLE`` of each other, at most two more rounds of the pool.
    Returns (batches run, each pool batch's first answer: the buffers its
    kept answer is copied into)."""
    last, bufs = None, []
    for i in range(3 * len(pool)):
        t = time.perf_counter()
        out = call(pool[i % len(pool)])
        t = time.perf_counter() - t
        if i < len(pool):
            bufs.append(out)
        elif abs(t - last) <= SETTLE * last:
            break
        last = t
    return i + 1, bufs


def keep(buf, out):
    """``out`` copied into ``buf`` (an array, or a tuple of them, of its
    shapes), or ``out`` itself where the shapes differ."""
    try:
        for b, o in zip(buf, out) if isinstance(buf, tuple) else [(buf, out)]:
            np.copyto(b, o)
    except (ValueError, TypeError):
        return out
    return buf


def measure(call, pool: list, seconds: float, keep_u: np.ndarray, bufs: list, annotate):
    """The closed-loop window. Returns (start, host seconds of each batch
    completed inside it, the kept answer of each pool batch or None, batches
    sent including the one in flight at the close). A kept answer is
    copied into the pool batch's buffer, so that the program's own
    allocations are freed as each batch returns, whichever sends are kept."""
    n = len(pool)
    times = np.empty(MAX_BATCHES)
    sends = [0] * n
    kept = [None] * n
    count = 0
    t0 = time.perf_counter()
    end = t0 + seconds
    while count < MAX_BATCHES:
        slot = count % n
        ts = time.perf_counter()
        with annotate():
            out = call(pool[slot])
        te = time.perf_counter()
        if te > end:
            return t0, times[:count], kept, count + 1
        times[count] = te - ts
        sends[slot] += 1
        if keep_u[count] * sends[slot] < 1:  # one answer a slot, uniform over its sends
            kept[slot] = keep(bufs[slot], out)
        out = None
        count += 1
    return t0, times[:count], kept, count


def card() -> dict:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return {}
    name, limit = out.splitlines()[0].rsplit(",", 1)
    return {"name": name.strip(), "power_limit": limit.strip()}


def check(entry, kept: list, pool: list, text_host: np.ndarray, config: dict, traffic: dict,
          device: torch.device, answers=None) -> tuple[dict, int]:
    """The kept answers against the reference: ({number: wrong reads},
    reads compared). ``answers`` replaces the kept answers (the control)."""
    ref = SuffixOrder(torch.from_numpy(text_host).to(device), text_host)
    wrong = {"batches_unanswered": 0}
    compared = 0
    for slot, got in enumerate(kept):
        reads = torch.from_numpy(pool[slot]).to(device)
        if answers is not None:
            got = answers(ref, reads, config, traffic)
        if got is None:
            wrong["batches_unanswered"] += 1
            continue
        for name, value in entry.compare(got, entry.expected(ref, reads, config, traffic)).items():
            wrong[name] = wrong.get(name, 0) + value
        compared += reads.shape[0]
    return wrong, compared


def log(msg: str) -> None:
    print(f"fmbench: {msg}", file=sys.stderr, flush=True)


def run(config: dict, traffic: dict, metrics: list, readers: dict, entry, seed: int, seconds: float,
        traced: bool, device: torch.device, t_start: float, fault=None) -> dict:
    """One run; returns the result line's object. ``metrics`` are the
    BENCHMARK.json entries to report, ``readers`` their readers by name;
    ``fault`` (tests) is called with the engine once it is built."""
    torch.set_num_threads(HOST_THREADS)
    stages = {"start_s": time.perf_counter() - t_start}
    t = time.perf_counter()
    text = gen.make_text(config["text_bases"], seed, device)
    pool = gen.make_pool(text, traffic, seed)
    text_host = text.cpu().numpy()
    del text
    stages["data_s"] = time.perf_counter() - t
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    t = time.perf_counter()
    engine, index_build_s = entry.build(config, traffic, text_host, device)
    stages["program_s"] = time.perf_counter() - t
    if fault is not None:
        fault(engine)

    def call(reads):
        return entry.call(engine, reads)

    t = time.perf_counter()
    stages["warm_batches"], bufs = warm_up(call, pool)
    stages["warm_s"] = time.perf_counter() - t
    keep_u = np.random.default_rng(gen.stream_seed(seed, gen.KEEP)).random(MAX_BATCHES)

    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        if traced:
            from torch.profiler import ProfilerActivity, profile, record_function

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
            with profile(activities=acts) as prof:
                with record_function(trace.WINDOW):
                    t0, batch_s, kept, sent = measure(call, pool, seconds, keep_u, bufs,
                                                      lambda: record_function(trace.BATCH))
        else:
            null = contextlib.nullcontext()
            t0, batch_s, kept, sent = measure(call, pool, seconds, keep_u, bufs, lambda: null)
    finally:
        gc.enable()
        gc.unfreeze()
    setup_s = t0 - t_start
    banned = banned_modules()
    if banned:
        raise SystemExit(f"fmbench: modules of {banned} are loaded; no run may load them")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del engine, call
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    tr = None
    if traced:
        t = time.perf_counter()
        tr = trace.reduce(trace.from_profiler(prof))
        del prof
        stages["trace_reduce_s"] = time.perf_counter() - t
    rec = Run(config=config, traffic=traffic, seconds=seconds, batch_s=batch_s, setup_s=setup_s,
              index_build_s=index_build_s, trace=tr, traced_reads=sent * traffic["batch_reads"])
    values = {}
    for m in metrics:
        v = readers[m["name"]](rec)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}

    t = time.perf_counter()
    wrong, compared = check(entry, kept, pool, text_host, config, traffic, device)
    stages["reference_s"] = time.perf_counter() - t
    limits = {name: 0 for name in wrong}
    correct = compared > 0 and all(wrong[n] <= limits[n] for n in wrong)

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
    result = {"correct": bool(correct), "attempted": rec.completed_reads,
              "failed": int(sum(v for n, v in wrong.items() if n != "batches_unanswered")),
              "metrics": values, "device": dev}
    if tr is not None:
        result["breakdown"] = tr.breakdown()
    result["batches"] = {"completed": len(batch_s), "sent": sent, "reads_compared": compared}
    if len(batch_s):
        q = np.percentile(batch_s, [0, 5, 25, 50, 75, 95, 100]) * 1e3
        result["batch_ms"] = dict(zip(["min", "p5", "p25", "p50", "p75", "p95", "max"], q.tolist()))
        result["batch_ms_by_tenth"] = [float(c.mean() * 1e3) for c in np.array_split(batch_s, 10) if len(c)]
    result["setup_stages"] = stages
    if device.type == "cuda":
        result["card"] = card()
    result["checks"] = {n: {"value": wrong[n], "limit": limits[n]} for n in wrong}
    return result
