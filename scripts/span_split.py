"""One benchmark cell's traced window, split by the program's spans.

    python3 scripts/span_split.py --workload <cell> --seed <n> --seconds <s> [--out FILE]

from the root of a checkout, on a CUDA device. Temporary: its reduction
belongs in ``fmbench/trace.py`` (``Trace.span_s`` / ``span_device_s``) with
readers under ``fmbench/metrics/``, which a change to the benchmark itself
brings; this script goes then. Until then it runs the cell as
``fmbench/run.py --trace 1`` does, through ``fmbench.harness.run``
unchanged, and keeps the profiler's raw events, taken where the harness
hands its profiler to ``fmbench.trace.from_profiler``. From them, on the
window's thread and clipped to the window:

- ``span_s``: host seconds of each ``tpufm.*`` and ``fmbench.*`` span;
- ``span_n``: how many instances of each;
- ``span_device_s``: device seconds of the kernels, copies and memsets whose
  launching runtime call (the same correlation id, on the window's thread)
  starts inside an instance of the span, at any depth;
- the read-back's blocking runtime calls (``BLOCKING``) inside
  ``tpufm.wave.readback``, on the profiler's one clock for host and device:
  ``readback_blocked_s``, their host seconds; ``readback_wait_s``, from each
  call's start to the device start of the copy it launched (a call with no
  copy waits throughout): the time the host waited for the stream's queued
  rounds, which the pageable copy to the host waits for (the program adds
  no synchronize of its own); ``readback_staging_s``, from the copy's device
  end to the call's end: the host's copy out of the driver's staging;
- ``readings``: figures per million reads of the window (the batch still in
  flight at its close included, as the harness counts them): host
  milliseconds in each wave step (the read-back split into its wait and
  the rest, and the staging apart), the upload's GB/s (the reads' bytes,
  as the cell's traffic gives them, over the upload's host seconds), the
  device milliseconds launched under ``tpufm.count.variants``, and the
  shares the spans cover of their parents.

The last line of standard output is the harness's result line with these
added under ``spans``; ``--out`` writes it to a file as well.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

#: span names this script reads: the program's and the harness's annotations
PREFIXES = ("tpufm.", "fmbench.")
#: the steps of a wave in ``stream_waves``
WAVE_STEPS = ("upload", "enqueue", "readback")
#: the span whose wait ``split`` reads, and the runtime calls in which it waits
READBACK = "tpufm.wave.readback"
BLOCKING = ("cudaMemcpyAsync", "cudaStreamSynchronize")


@dataclasses.dataclass
class Ev:
    kind: str  # "span", "host", or on the device "kernel", "copy", "memset"
    name: str
    start: int  # ns
    end: int  # ns
    thread: int = 0
    corr: int = 0


def events(prof) -> list[Ev]:
    """The events of a finished ``torch.profiler.profile``, classed as
    ``fmbench.trace`` classes them, with every ``tpufm.*`` and ``fmbench.*``
    name an annotation where the profiler gives no class (so that a span's
    device mirror is never taken for a kernel). A host event keeps its
    correlation id only if it is a CUDA API call (``cuda*``, ``cu*``): an
    operator's id counts in another sequence and may equal a launch's."""
    from fmbench import trace

    raw = prof.profiler.kineto_results.events()
    annotations = {e.name() for e in raw if e.name().startswith(PREFIXES)}
    out = []
    for e in raw:
        kind = trace._kind(e, annotations)
        if kind in trace.DEVICE_KINDS:
            out.append(Ev(trace.DEVICE_KINDS[kind], e.name(), e.start_ns(), e.end_ns(), corr=e.correlation_id()))
        elif kind == "user_annotation":
            out.append(Ev("span", e.name(), e.start_ns(), e.end_ns(), e.start_thread_id()))
        elif kind in trace.HOST_KINDS:
            runtime = kind.startswith("cuda_") or e.name().startswith("cu")
            out.append(Ev("host", e.name(), e.start_ns(), e.end_ns(), e.start_thread_id(),
                          e.correlation_id() if runtime else 0))
    return out


def split(evs: list[Ev], window: str = "fmbench.window") -> dict:
    """``span_s``, ``span_n``, ``span_device_s`` and the read-back's
    blocked, wait and staging seconds (see the module docstring) inside the
    longest ``window`` span."""
    win = max((e for e in evs if e.kind == "span" and e.name == window), key=lambda e: e.end - e.start)
    w0, w1 = win.start, win.end
    spans = sorted((e for e in evs if e.kind == "span" and e.thread == win.thread
                    and e.name.startswith(PREFIXES) and e.end > w0 and e.start < w1),
                   key=lambda e: (e.start, -e.end))
    span_s, span_n = {}, {}
    for e in spans:
        span_s[e.name] = span_s.get(e.name, 0.0) + (min(e.end, w1) - max(e.start, w0)) / 1e9
        span_n[e.name] = span_n.get(e.name, 0) + 1
    device_s = {}
    for e in evs:
        if e.kind not in ("span", "host") and e.corr and e.end > w0 and e.start < w1:
            device_s[e.corr] = device_s.get(e.corr, 0.0) + (min(e.end, w1) - max(e.start, w0)) / 1e9
    # the launching call: the runtime call of the id, on the spans' thread
    launch_at = {e.corr: e.start for e in evs
                 if e.kind == "host" and e.corr in device_s and e.thread == win.thread}
    # spans on one thread nest: a stack of the open ones, innermost on top
    span_device_s, stack, i = {}, [], 0
    for t, corr in sorted((t, c) for c, t in launch_at.items()):
        while i < len(spans) and spans[i].start <= t:
            while stack and stack[-1].end <= spans[i].start:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1].end < t:
            stack.pop()
        for name in {s.name for s in stack}:
            span_device_s[name] = span_device_s.get(name, 0.0) + device_s[corr]
    # read-backs do not nest: the one that started last before a call holds it, if it is still open
    backs = [(s.start, s.end) for s in spans if s.name == READBACK]
    copies = {}  # launching call's id -> (first device start, last device end) of its copies
    for e in evs:
        if e.kind == "copy" and e.corr:
            c0, c1 = copies.get(e.corr, (e.start, e.end))
            copies[e.corr] = (min(c0, e.start), max(c1, e.end))
    blocked = wait = staging = 0
    for e in evs:
        if e.kind == "host" and e.name in BLOCKING and e.thread == win.thread and e.end > w0 and e.start < w1:
            j = bisect.bisect_right(backs, (e.start, float("inf"))) - 1
            if j < 0 or e.end > backs[j][1]:
                continue
            a, b = max(e.start, w0), min(e.end, w1)
            blocked += b - a
            c0, c1 = copies.get(e.corr, (b, b))
            wait += min(max(c0, a), b) - a
            staging += b - max(min(c1, b), a)
    return {"span_s": span_s, "span_n": span_n, "span_device_s": span_device_s,
            "readback_blocked_s": blocked / 1e9, "readback_wait_s": wait / 1e9,
            "readback_staging_s": staging / 1e9}


def readings(spans: dict, reads: int, read_len: int) -> dict:
    """Figures per million ``reads`` of ``read_len`` bases from ``split``'s
    maps; a figure whose span is missing is left out."""
    span_s, dev_s = spans["span_s"], spans["span_device_s"]
    mreads = reads / 1e6
    out = {}
    for step in WAVE_STEPS:
        if f"tpufm.wave.{step}" in span_s:
            out[f"{step}_ms_per_mread"] = span_s[f"tpufm.wave.{step}"] * 1e3 / mreads
    if READBACK in span_s and spans.get("readback_blocked_s"):
        out["wait_ms_per_mread"] = spans["readback_wait_s"] * 1e3 / mreads
        out["readback_ms_per_mread"] = (span_s[READBACK] - spans["readback_wait_s"]) * 1e3 / mreads
        out["staging_ms_per_mread"] = spans["readback_staging_s"] * 1e3 / mreads
    if span_s.get("tpufm.wave.upload"):
        out["upload_gbps"] = reads * read_len / span_s["tpufm.wave.upload"] / 1e9
    if "tpufm.count.variants" in dev_s:
        out["variants_device_ms_per_mread"] = dev_s["tpufm.count.variants"] * 1e3 / mreads
    top = span_s.get("tpufm.count") or span_s.get("tpufm.search")
    if top:
        out["wave_steps_share_of_call"] = sum(span_s.get(f"tpufm.wave.{s}", 0.0) for s in WAVE_STEPS) / top
        if span_s.get("fmbench.batch"):
            out["call_share_of_batch"] = top / span_s["fmbench.batch"]
    return out


def traced_run(config: dict, traffic: dict, metrics: list, readers: dict, entry, seed: int,
               seconds: float, device, t_start: float) -> dict:
    """``fmbench.harness.run`` with ``--trace 1``'s arguments; its result
    line with ``spans`` added. The harness's reduction is wrapped only to
    keep the profiler's events."""
    from fmbench import harness, trace

    kept = {}
    from_profiler = trace.from_profiler

    def keep_events(prof):
        kept["events"] = events(prof)
        return from_profiler(prof)

    trace.from_profiler = keep_events
    try:
        result = harness.run(config, traffic, metrics, readers, entry, seed, seconds, True, device, t_start)
    finally:
        trace.from_profiler = from_profiler
    spans = split(kept.pop("events"))
    reads = result["batches"]["sent"] * traffic["batch_reads"]
    spans.update(reads=reads, readings=readings(spans, reads, traffic["read_len"]))
    result["spans"] = spans
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    torch.set_num_interop_threads(1)
    from fmbench import registry

    bench = registry.benchmark()
    cell = registry.cell(bench, args.workload)
    metrics = registry.metrics(bench, cell["name"], True)
    readers = {m["name"]: registry.metric(m["name"]) for m in metrics}
    traffic = registry.traffic(cell["traffic"])
    result = traced_run(registry.config(bench, cell["config"]), traffic, metrics, readers,
                        registry.entry(traffic["entry"]), args.seed, args.seconds,
                        torch.device("cuda", 0), T_START)
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
