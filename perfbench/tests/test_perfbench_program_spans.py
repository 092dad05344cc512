"""The readers of the program's own spans (perfbench/program_spans.py) on a
synthetic trace: milliseconds per request, clipping to the traced
stretch, nothing from a trace without `dmmt.` events, the capture count,
coverage of the benchmark's ranges, and the breakdown's labels."""

import json

import pytest

from perfbench import harness, program_spans
from perfbench.harness import Run
from perfbench.trace import Event, Trace, breakdown

ROOT = harness.ROOT
NEW = [m["name"] for m in json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]
       if m["source"] == "program_span" and m["name"].split(".")[0] not in
       ("start_host_ms", "finish_host_ms", "stage_host_ms")]


def synthetic(host) -> Run:
    """Two requests in a 100 us stretch, with these host events."""
    t = Trace(requests=2, images=2, start=0.0, end=100.0)
    t.host = [Event("request", 0, 45), Event("request", 50, 100), *host]
    run = Run(device="cuda")
    run.trace = t
    return run


def test_thirteen_program_span_metrics():
    assert len(NEW) == 13 and "graph_captures" in NEW


def test_milliseconds_per_request():
    run = synthetic([Event("finish", 10, 40), Event("dmmt.stuff", 10, 20),
                     Event("dmmt.stuff", 60, 80), Event("dmmt.word_fetch", 20, 25)])
    assert program_spans.program_span_ms(run, "dmmt.stuff") == pytest.approx(0.015)
    assert harness.reader("stuff_host_ms.single")(run) == pytest.approx(0.015)
    assert harness.reader("word_fetch_ms.batch")(run) == pytest.approx(0.0025)
    assert harness.reader("container_host_ms.single")(run) == 0.0  # spans, none of this name


def test_spans_are_clipped_to_the_stretch():
    run = synthetic([Event("dmmt.fill", -10, 5), Event("dmmt.fill", 95, 110),
                     Event("dmmt.fill", 120, 130)])
    assert harness.reader("fill_host_ms.single")(run) == pytest.approx(0.005)
    assert program_spans.span_count(run, "dmmt.fill") == 2


@pytest.mark.parametrize("name", NEW)
def test_nothing_without_program_spans(name):
    run = synthetic([Event("finish", 10, 40), Event("cudaEventSynchronize", 12, 28),
                     Event("jpeg", 40, 44)])
    assert harness.reader(name)(run) is None
    assert harness.reader(name)(Run(device="cpu")) is None


def test_graph_captures_counts_capture_spans():
    spans = [Event("dmmt.lease", 2, 9), Event("dmmt.fill", 9, 12), Event("dmmt.replay", 12, 14)]
    assert harness.reader("graph_captures")(synthetic(spans)) == 0
    with_one = synthetic([*spans, Event("dmmt.capture", 3, 8)])
    assert harness.reader("graph_captures")(with_one) == 1


def test_coverage_of_the_benchmarks_ranges():
    run = synthetic([Event("finish", 10, 40), Event("dmmt.bits_wait", 10, 15),
                     Event("dmmt.stuff", 20, 37), Event("finish", 60, 70),
                     Event("dmmt.stuff", 60, 70)])
    assert program_spans.coverage(run.trace, "finish") == pytest.approx(32 / 40)
    assert program_spans.coverage(run.trace, "upload") is None
    run.trace.host += [Event("jpeg", 40, 44), Event("dmmt.container", 41, 44)]
    assert program_spans.coverage(run.trace, "finish", "jpeg") == pytest.approx(35 / 44)


def test_breakdown_names_idle_time_by_the_program_span():
    t = Trace(start=0.0, end=100.0)
    t.kernels = [Event("k1", 0, 10), Event("k2", 50, 60)]
    t.host = [Event("request", 0, 45), Event("request", 55, 100), Event("finish", 5, 45),
              Event("dmmt.bits_wait", 5, 10), Event("dmmt.stuff", 10, 45),
              Event("jpeg", 60, 100), Event("dmmt.container", 60, 100)]
    gaps = dict(breakdown(t)["idle_gaps"])
    assert gaps == {"finish > dmmt.stuff": 40e-6, "jpeg > dmmt.container": 40e-6}
