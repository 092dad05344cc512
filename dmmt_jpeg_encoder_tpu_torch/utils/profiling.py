"""Profiling helpers: a device trace around a block, the program's host
spans, and host stage timers.

Counterpart of dmmt_jpeg_encoder_tpu.utils.profiling, with the trace taken
by torch.profiler (CPU activity, and CUDA activity where a card is present)
in place of jax.profiler. `span(name)` marks a stretch of the encode path's
host work (the `dmmt.` spans: upload, lease, replay, the finish's wait,
spec decode, word fetch, stuffing, the container) as a torch.profiler range,
so it lies on the device trace's clock; with no profiler recording it is
one flag read and a shared no-op context. `trace` and `stage_timer` are
debugging aids the encode path does not call.

Usage:
    from dmmt_jpeg_encoder_tpu_torch.utils.profiling import trace, stage_timer

    with trace("traces/encode"):           # open trace.json in Perfetto:
        encode_array(pixels)               # the kernels and the dmmt. spans

    with stage_timer() as t:
        result = run_device_pipeline(...)
        t.lap("pipeline")
        ...
    print(t.report())
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch
import torch.autograd.profiler as _autograd_profiler

# what span gives while no profiler records: reusable, and safe on any thread
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A profiler range named `name` while torch.profiler records (in the
    chrome trace a `cpu_op` event of the calling thread), else the shared
    no-op context; the check is one flag read. The range is torch's C++
    RecordFunction context (`_RecordFunctionFast`), not `record_function`,
    which dispatches a profiler op on entry and on exit, even when nothing
    records: several times the cost a span, and as much time left outside
    the spans between two neighbours."""
    if _autograd_profiler._is_profiler_enabled:
        return torch._C._profiler._RecordFunctionFast(name)
    return _NO_SPAN


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace around a block, written as a Chrome trace to
    log_dir/trace.json; no trace (and no error) when the profiler cannot
    start."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    try:
        profiler.start()
        started = True
    except RuntimeError:
        started = False
    try:
        yield
    finally:
        if started:
            profiler.stop()
            Path(log_dir).mkdir(parents=True, exist_ok=True)
            profiler.export_chrome_trace(str(Path(log_dir) / "trace.json"))


class StageTimer:
    def __init__(self) -> None:
        self._t0 = time.perf_counter()
        self.laps: list[tuple[str, float]] = []

    def lap(self, name: str) -> float:
        now = time.perf_counter()
        dt = now - self._t0
        self._t0 = now
        self.laps.append((name, dt))
        return dt

    def report(self) -> str:
        total = sum(dt for _, dt in self.laps)
        lines = [f"{name}: {dt * 1e3:.1f} ms" for name, dt in self.laps]
        lines.append(f"total: {total * 1e3:.1f} ms")
        return " | ".join(lines)


@contextlib.contextmanager
def stage_timer():
    yield StageTimer()
