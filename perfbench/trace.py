"""The traced stretch of a run: spans around the program's calls, and the
device trace of torch.profiler, reduced to what the per-layer readers use.

Spans come from the benchmark's own wrappers around the names the
program's `encoder` module calls (`start_one_dispatch`,
`start_one_dispatch_slab`, `finish_one_dispatch`, `_jpeg`, `_upload`):
each adds its host seconds to `Trace.spans` and opens a profiler range of
its name. The profiler's chrome trace is written to TMPDIR, read once and
deleted.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import threading
import time
from bisect import bisect_right
from collections import defaultdict
from dataclasses import dataclass, field

# the port's hand-written kernels (csrc/*.cu), by the name of their
# __global__ function
PORT_KERNELS = ("phase1_kernel", "block_hist_kernel", "pack_kernel", "histogram_kernel",
                "lookup_kernel", "plane_dct_kernel", "plane_dct_mm_kernel", "phase1_mm_kernel",
                "block_dct_zz_kernel", "add_one_kernel")
# wrapped names of the program's encoder module -> span name
SPANS = {"start_one_dispatch": "start", "start_one_dispatch_slab": "start",
         "finish_one_dispatch": "finish", "_jpeg": "jpeg", "_upload": "upload"}
# idle gaps shorter than this are counted together, unnamed
GAP_NAMED_US = 10.0


def kernel_base(name: str) -> str:
    """`void (anonymous namespace)::pack_kernel<true>(short const*, ...)` ->
    `pack_kernel`."""
    head = name.replace("(anonymous namespace)::", "").split("(", 1)[0].split("<", 1)[0]
    return head.rsplit("::", 1)[-1].split(" ")[-1]


def is_port_kernel(name: str) -> bool:
    return kernel_base(name) in PORT_KERNELS and "at::" not in name and "cub" not in name


def short_name(name: str) -> str:
    """A device operation's name without its argument list, at most 100
    characters."""
    name = name.replace("(anonymous namespace)::", "")
    if "(" in name and not name.startswith("Memcpy") and not name.startswith("Memset"):
        name = name.split("(", 1)[0]
    return name.removeprefix("void ")[:100]


@dataclass
class Event:
    name: str
    start: float  # us, in the trace's timebase
    end: float
    correlation: int = -1


@dataclass
class Trace:
    """What the per-layer readers read. Times in the profiler's
    microseconds; `spans` in host seconds."""

    requests: int = 0
    images: int = 0
    start: float = 0.0
    end: float = 0.0
    kernels: list = field(default_factory=list)
    copies: list = field(default_factory=list)
    host: list = field(default_factory=list)
    graph_launches: set = field(default_factory=set)
    spans: dict = field(default_factory=lambda: defaultdict(float))
    scan_bits: list = field(default_factory=list)
    graph_bytes: int = 0
    shape: tuple = ()  # (height, width, horizontal rate, vertical rate)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def replays(self) -> list[list[Event]]:
        """The kernels of each graph replay, grouped by the correlation id of
        their cudaGraphLaunch."""
        by = defaultdict(list)
        for k in self.kernels:
            if k.correlation in self.graph_launches:
                by[k.correlation].append(k)
        return list(by.values())

    def replay_ms(self) -> list[float]:
        """Each replay's device span: its first kernel's start to its last
        kernel's end."""
        return [(max(k.end for k in r) - min(k.start for k in r)) / 1e3 for r in self.replays()]


def _union(intervals) -> float:
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def busy_us(events, start: float, end: float) -> float:
    """Microseconds of [start, end] covered by the events."""
    return _union((max(e.start, start), min(e.end, end)) for e in events
                  if e.end > start and e.start < end)


def idle_gaps(events, start: float, end: float) -> list[tuple[float, float]]:
    """The stretches of [start, end] that no event covers."""
    gaps, cur = [], start
    for e in sorted(events, key=lambda e: e.start):
        if e.start > cur:
            gaps.append((cur, min(e.start, end)))
        cur = max(cur, e.end)
        if cur >= end:
            break
    if cur < end:
        gaps.append((cur, end))
    return [(s, e) for s, e in gaps if e > s]


def host_activity(host: list[Event], starts: list[float], requests: list[tuple], t: float) -> str:
    """What the host was doing at t: the outermost benchmark span and the
    innermost host event covering t (`host` sorted by start, without the
    request ranges); "request, outside the spans" where only a request's
    own range covers t, "between requests" where nothing does."""
    outer, inner = None, None
    i = bisect_right(starts, t)
    for e in reversed(host[max(0, i - 400):i]):
        if e.end >= t:
            if e.name in SPANS.values():
                outer = e.name
            if inner is None or e.end - e.start < inner.end - inner.start:
                inner = e
    if inner is None:
        j = bisect_right(requests, (t, float("inf"))) - 1
        return "request, outside the spans" if j >= 0 and requests[j][1] >= t else "between requests"
    return f"{outer} > {inner.name}" if outer and outer != inner.name else inner.name


def breakdown(trace: Trace) -> dict:
    """The device operations that took most time, and the idle time (no
    kernel, copy or set) by what the host was doing, ten of each."""
    ops = defaultdict(float)
    for e in trace.kernels + trace.copies:
        if e.end > trace.start and e.start < trace.end:
            ops[short_name(e.name)] += (e.end - e.start) / 1e6
    host = sorted((e for e in trace.host if e.name != "request"), key=lambda e: e.start)
    starts = [e.start for e in host]
    requests = sorted((e.start, e.end) for e in trace.host if e.name == "request")
    gaps = defaultdict(float)
    for s, e in idle_gaps(trace.kernels + trace.copies, trace.start, trace.end):
        name = host_activity(host, starts, requests, (s + e) / 2) if e - s >= GAP_NAMED_US \
            else f"gaps under {GAP_NAMED_US:g} us"
        gaps[name] += (e - s) / 1e6
    top = (lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]])
    return {"device_ops": top(ops), "idle_gaps": top(gaps)}


def read_chrome_trace(path: str, trace: Trace) -> None:
    """Fill trace's events from a torch.profiler chrome trace; the traced
    stretch runs from the first `request` range's start to the last one's
    end, and the host events are those of the threads that ran them."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    requests = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == "request"]
    tids = {e.get("tid") for e in requests}
    if requests:
        trace.start = min(float(e["ts"]) for e in requests)
        trace.end = max(float(e["ts"]) + float(e.get("dur", 0)) for e in requests)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0))
        corr = int((e.get("args") or {}).get("correlation", -1))
        ev = Event(name, ts, ts + dur, corr)
        if cat == "kernel":
            trace.kernels.append(ev)
        elif cat in ("gpu_memcpy", "gpu_memset"):
            trace.copies.append(ev)
        elif cat in ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver") and e.get("tid") in tids:
            trace.host.append(ev)
            if cat in ("cuda_runtime", "cuda_driver") and "GraphLaunch" in name:
                trace.graph_launches.add(corr)


@contextlib.contextmanager
def spans_on(encoder_module, trace: Trace, torch):
    """Wrap the encoder module's calls in timed spans and profiler ranges;
    restore on exit."""
    saved = {name: getattr(encoder_module, name) for name in SPANS}
    lock = threading.Lock()

    def wrap(fn, span):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            with torch.profiler.record_function(span):
                try:
                    return fn(*a, **kw)
                finally:
                    with lock:
                        trace.spans[span] += time.perf_counter() - t0
        return timed

    for name, span in SPANS.items():
        setattr(encoder_module, name, wrap(saved[name], span))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(encoder_module, name, fn)


def export(prof, trace: Trace) -> None:
    """Write the profiler's chrome trace under TMPDIR, read it, delete it."""
    fd, path = tempfile.mkstemp(suffix=".json", dir=os.environ.get("TMPDIR"))
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        read_chrome_trace(path, trace)
    finally:
        os.unlink(path)
