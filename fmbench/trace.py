"""The device trace of a window, reduced to what the metrics read.

Events come from ``torch.profiler`` (the pattern of tpufm_torch/profiling.py's
``trace``, with the benchmark's own reduction): device events are kernels,
copies and memsets; host events are the operators, runtime calls and
annotations of the thread that ran the window. Timestamps are nanoseconds on
the profiler's one clock, so device and host events compare directly.
"""

from __future__ import annotations

import dataclasses
import re

#: profiler activity types by the benchmark's kind of event
DEVICE_KINDS = {"kernel": "kernel", "gpu_memcpy": "copy", "gpu_memset": "memset"}
HOST_KINDS = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"}
#: host events of the profiler itself
OVERHEAD = {"Activity Buffer Request"}
#: the annotation around the measured window, and around each batch
WINDOW, BATCH = "fmbench.window", "fmbench.batch"


@dataclasses.dataclass
class Event:
    kind: str  # "kernel", "copy", "memset" (device) or "host"
    name: str
    start: int  # ns
    end: int  # ns
    thread: int = 0


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    #: device seconds by event name, and by kind
    device_s: dict
    kernel_s: float
    copy_s: float  # host to device and device to host copies
    launches: int
    #: idle device seconds by the innermost host event running then
    idle_s: dict

    def kernel_time(self, patterns) -> float:
        """Device seconds of the kernels whose names hold one of ``patterns``."""
        return sum(s for (kind, name), s in self.device_s.items()
                   if kind == "kernel" and any(p in name for p in patterns))

    def breakdown(self) -> dict:
        """The ten device operations that took most time and the ten host
        events under which the device idled longest, seconds each."""
        ops = sorted(((short(name), s) for (_, name), s in self.device_s.items()), key=lambda x: -x[1])
        gaps = sorted(((short(name), s) for name, s in self.idle_s.items()), key=lambda x: -x[1])
        return {"device_ops": [list(x) for x in ops[:10]], "idle_gaps": [list(x) for x in gaps[:10]]}


def short(name: str) -> str:
    """A device or host event's name as a metric-safe label."""
    return re.sub(r"[^A-Za-z0-9_.-]", "_", name)[:64]


def from_profiler(prof) -> list[Event]:
    """The events of a finished ``torch.profiler.profile``."""
    raw = prof.profiler.kineto_results.events()
    annotations = {e.name() for e in raw if e.name().startswith("fmbench.")}
    out = []
    for e in raw:
        kind = _kind(e, annotations)
        if kind in DEVICE_KINDS:
            out.append(Event(DEVICE_KINDS[kind], e.name(), e.start_ns(), e.end_ns()))
        elif kind in HOST_KINDS:
            out.append(Event("host", e.name(), e.start_ns(), e.end_ns(), e.start_thread_id()))
    return out


def _kind(e, annotations) -> str:
    """The profiler's activity type of ``e``; where the profiler does not
    give it, from the event's device, ``is_user_annotation`` and name: an
    annotation (or on the device its mirror), a copy, a memset or a kernel;
    on the host the profiler's own bookkeeping or an operator."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    name = e.name()
    on_device = e.device_type().name == "CUDA"
    if getattr(e, "is_user_annotation", lambda: name in annotations)():
        return "gpu_user_annotation" if on_device else "user_annotation"
    if not on_device:
        return "overhead" if name in OVERHEAD else "cpu_op"
    return "gpu_memcpy" if name.startswith("Memcpy") else "gpu_memset" if name.startswith("Memset") else "kernel"


def _union(intervals):
    """Sorted, merged (start, end) of ``intervals``."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _label_gaps(gaps, host):
    """Seconds of each gap by the innermost host event covering its middle
    (events of one thread nest); "idle host" where none does."""
    host = sorted(host, key=lambda e: (e.start, -e.end))
    out, stack, i = {}, [], 0
    for s, e in sorted(gaps):
        mid = (s + e) // 2
        while i < len(host) and host[i].start <= mid:
            while stack and stack[-1].end <= host[i].start:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1].end < mid:
            stack.pop()
        name = stack[-1].name if stack else "idle host"
        out[name] = out.get(name, 0.0) + (e - s) / 1e9
    return out


def reduce(events: list[Event]) -> Trace:
    """The trace inside the window annotation (``WINDOW``): device busy
    time as the union of device events, their time by name, kernel and copy
    seconds, kernel launches, and the idle gaps by host event."""
    window = max((e for e in events if e.kind == "host" and e.name == WINDOW), key=lambda e: e.end - e.start)
    w0, w1 = window.start, window.end
    device = []
    for e in events:
        if e.kind != "host" and e.end > w0 and e.start < w1:
            device.append(dataclasses.replace(e, start=max(e.start, w0), end=min(e.end, w1)))
    busy = _union((e.start, e.end) for e in device)
    device_s, kernel_s, copy_s = {}, 0.0, 0.0
    for e in device:
        s = (e.end - e.start) / 1e9
        device_s[(e.kind, e.name)] = device_s.get((e.kind, e.name), 0.0) + s
        if e.kind == "kernel":
            kernel_s += s
        elif e.kind == "copy" and ("HtoD" in e.name or "DtoH" in e.name):
            copy_s += s
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < w1:
        gaps.append((t, w1))
    host = [e for e in events if e.kind == "host" and e.thread == window.thread
            and e.end > w0 and e.start < w1]
    return Trace(
        window_s=(w1 - w0) / 1e9,
        busy_s=sum(e - s for s, e in busy) / 1e9,
        device_s=device_s,
        kernel_s=kernel_s,
        copy_s=copy_s,
        launches=sum(e.kind == "kernel" for e in device),
        idle_s=_label_gaps(gaps, host),
    )
