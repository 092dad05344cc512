"""Device time of a call as the card runs it, with CUDA events.

`device_ms(fn)` times R back-to-back calls of fn between two CUDA events
on the current stream and divides by R, with R chosen from one timed call
so that the window holds at least `window_ms`; it returns the median of
`windows` such windows. Each window starts behind a spin kernel
(`torch.cuda._sleep`) that lasts longer than the host takes to enqueue all
R calls, so the card runs them back to back and the window holds the
card's time, not the host's enqueue: a ctypes wrapper can take longer to
enqueue a small kernel than the card takes to run it. A call that waits
for the card inside (a fetch to the host) still shows the host's share.
Needs a CUDA card.
"""

from __future__ import annotations

import math
import statistics
import time

import torch

MAX_SPIN_MS = 500.0
_CYCLES_PER_MS: list[float] = []


def _spin_cycles_per_ms() -> float:
    """Cycles of torch.cuda._sleep per ms on this card (measured once)."""
    if not _CYCLES_PER_MS:
        torch.cuda._sleep(1000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        end.synchronize()
        _CYCLES_PER_MS.append(10_000_000 / start.elapsed_time(end))
    return _CYCLES_PER_MS[0]


def _window(fn, runs: int, host_ms: float) -> float:
    """ms per call of `runs` calls enqueued behind a spin kernel."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    spin_ms = min(2.0 * host_ms * runs + 0.1, MAX_SPIN_MS)
    torch.cuda._sleep(int(spin_ms * _spin_cycles_per_ms()))
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / runs


def device_ms(fn, window_ms: float = 2.0, windows: int = 5, max_runs: int = 1000) -> float:
    """Median over `windows` windows of the card's ms per fn() call."""
    fn()
    torch.cuda.synchronize()
    host = []
    for _ in range(2):
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    one = _window(fn, 1, max(host))
    runs = max(1, min(max_runs, math.ceil(window_ms / max(one, 1e-4))))
    return statistics.median(_window(fn, runs, max(host)) for _ in range(windows))
