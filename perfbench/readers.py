"""What the metric readers under perfbench/metrics/ share. A reader takes
the run (harness.Run) and returns a number, or None where it finds
nothing to read; the harness then leaves the metric out."""

from __future__ import annotations

import math

from perfbench import roofline
from perfbench.trace import busy_us, is_port_kernel, kernel_base


def p95_ms(run) -> float:
    """Nearest-rank 95th percentile of the requests' latencies; a failed
    request, or one with a wrong JPEG, counts as missing: as long as the
    window."""
    lat = sorted(min(s, run.window_s) if ok else run.window_s
                 for s, ok in zip(run.latencies_s, run.request_ok))
    return lat[math.ceil(0.95 * len(lat)) - 1] * 1e3 if lat else None


def span_ms(run, *names) -> float | None:
    """Host milliseconds per traced request in the benchmark's spans."""
    t = run.trace
    if t is None or not t.requests or not any(t.spans.get(n) for n in names):
        return None
    return sum(t.spans.get(n, 0.0) for n in names) / t.requests * 1e3


def replay_device_ms(run) -> float | None:
    """Device milliseconds per request of the graph replays, each from its
    first kernel's start to its last kernel's end; nothing where the trace
    shows no replayed kernel."""
    t = run.trace
    spans = t.replay_ms() if t is not None and t.requests else []
    return sum(spans) / t.requests if spans else None


def torch_ops_ms(run) -> float | None:
    """Device milliseconds per request of the replayed kernels that are not
    the port's hand-written ones."""
    t = run.trace
    replays = t.replays() if t is not None else []
    if not replays:
        return None
    return sum(k.end - k.start for r in replays for k in r if not is_port_kernel(k.name)) \
        / t.requests / 1e3


def _kernel_seconds(t, match) -> float:
    return sum(k.end - k.start for k in t.kernels
               if k.end > t.start and k.start < t.end and match(k.name)) / 1e6


def phase1_roofline(run) -> float | None:
    """Percent: least time of phase 1 over the traced images, over the
    phase-1 kernel's measured time."""
    t = run.trace
    measured = _kernel_seconds(t, lambda n: kernel_base(n) == "phase1_kernel") if t else 0.0
    if not measured:
        return None
    return 100.0 * t.images * roofline.phase1_seconds(*t.shape) / measured


def scan_pack_roofline(run) -> float | None:
    """Percent: least time of the traced images' scan packs (each from its
    stream's length), over the scan-pack kernel's measured time."""
    t = run.trace

    def scan_pack(name):  # K3, not the emission pack's pack_kernel<true/false>
        return kernel_base(name) == "pack_kernel" and "pack_kernel<" not in name

    measured = _kernel_seconds(t, scan_pack) if t else 0.0
    if not measured:
        return None
    return 100.0 * sum(roofline.scan_pack_seconds(*t.shape, b) for b in t.scan_bits) / measured


def device_idle_pct(run) -> float | None:
    """Percent of the traced stretch in which no kernel runs on the card."""
    t = run.trace
    if t is None or not t.kernels or t.end <= t.start:
        return None
    return 100.0 * (1.0 - busy_us(t.kernels, t.start, t.end) / (t.end - t.start))
