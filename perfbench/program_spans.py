"""The program's own host spans in the traced stretch: the `dmmt.` ranges
that the port opens around its host work (utils/profiling.span) while
torch.profiler records, which `read_chrome_trace` keeps in `Trace.host`
with the other host events of the request threads. Where the trace holds
no `dmmt.` event at all (a program without the spans), every reader here
finds nothing.

    python3 -m perfbench.program_spans --workload NAME --seed N --seconds S

runs one cell traced, as perfbench/run.py does with --trace 1, prints its
result line, and then, on standard error, the share of each of the
benchmark's own ranges (`start`, `finish`, `jpeg`, `upload`:
perfbench/trace.SPANS; and `finish` + `jpeg`, the ranges of
finish_host_ms) that the program's spans cover.
"""

from __future__ import annotations

import time

T0 = time.monotonic()  # set-up is timed from here, as in perfbench/run.py

import sys  # noqa: E402

from perfbench.trace import SPANS, Event, Trace, busy_us  # noqa: E402

PREFIX = "dmmt."


def _program_events(run) -> list[Event] | None:
    """The traced stretch's `dmmt.` events, or None where there are none."""
    t = run.trace
    if t is None or not t.requests:
        return None
    events = [e for e in t.host if e.name.startswith(PREFIX)]
    return events or None


def program_span_ms(run, name: str) -> float | None:
    """Host milliseconds per traced request in the program's spans named
    `name`, clipped to the traced stretch."""
    events = _program_events(run)
    if events is None:
        return None
    t = run.trace
    return busy_us([e for e in events if e.name == name], t.start, t.end) / t.requests / 1e3


def span_count(run, name: str) -> int | None:
    """The program's spans named `name` that overlap the traced stretch."""
    events = _program_events(run)
    if events is None:
        return None
    t = run.trace
    return sum(1 for e in events if e.name == name and e.end > t.start and e.start < t.end)


def coverage(trace: Trace, *outers: str) -> float | None:
    """The share of the benchmark's ranges named `outers`, within the traced
    stretch, that the program's spans cover; None where there is no such
    range."""
    inner = [e for e in trace.host if e.name.startswith(PREFIX)]
    total = covered = 0.0
    for o in trace.host:
        if o.name in outers:
            s, e = max(o.start, trace.start), min(o.end, trace.end)
            if e > s:
                total += e - s
                covered += busy_us(inner, s, e)
    return covered / total if total else None


def main(argv: list[str]) -> int:
    from perfbench import harness, trace as tracing

    kept = []
    export = tracing.export

    def export_and_keep(prof, traced):
        export(prof, traced)
        kept.append(traced)

    tracing.export = export_and_keep
    try:
        rc = harness.main([*argv, "--trace", "1"], T0)
    finally:
        tracing.export = export
    for t in kept:
        for outers in [(name,) for name in sorted(set(SPANS.values()))] + [("finish", "jpeg")]:
            share = coverage(t, *outers)
            if share is not None:
                harness.log(f"coverage of {' + '.join(outers)} by the program's spans: "
                            f"{100 * share:.2f}%")
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
