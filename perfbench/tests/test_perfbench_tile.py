"""The map-tile cell (`bmng21600_p420.tile`) on the CPU: its pool of exactly
two distinct tiles, its metrics, and the readers of the two-dispatch host
tail's program spans on a synthetic trace."""

import json

import pytest

from perfbench import harness
from perfbench.harness import Run
from perfbench.trace import Event, Trace

CELL = "bmng21600_p420.tile"
# reader -> the program span it reads
TAIL = {"hist_wait_ms.tile": "dmmt.hist_wait", "host_tables_ms.tile": "dmmt.host_tables",
        "pack_wait_ms.tile": "dmmt.pack_wait", "word_fetch_ms.tile": "dmmt.word_fetch",
        "stuff_host_ms.tile": "dmmt.stuff"}


def test_the_tile_pool_holds_exactly_two_tiles():
    cell = harness.Cell.load(CELL)
    assert (cell.config["height"], cell.config["width"]) == (21600, 21600)
    assert harness.pool_size(cell.traffic, cell.config["height"], cell.config["width"]) == 2
    assert cell.traffic["call"] == "encode_array" and cell.traffic["batch"] == 1


def test_the_tile_cell_reports_its_metrics():
    cell = harness.Cell.load(CELL)
    assert [m["name"] for m in cell.end_to_end] == ["encode_mpix_s", "device_peak_gib", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == list(TAIL)
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    others = [w["name"] for w in bench["workloads"] if w["name"] != CELL]
    assert all(set(TAIL).isdisjoint(m["name"] for m in harness.Cell.load(c).per_layer)
               for c in others)


def tile_run() -> Run:
    """Two tile requests in a 1,000 us stretch, each with its tail's spans;
    a third request's spans lie past the stretch's end."""
    t = Trace(requests=2, images=2, start=0.0, end=1000.0)
    t.host = [Event("request", 0, 480), Event("request", 500, 1000)]
    for base in (0, 500, 1000):
        t.host += [Event("dmmt.fill", base, base + 200), Event("dmmt.replay", base + 200, base + 210),
                   Event("dmmt.hist_wait", base + 210, base + 240),
                   Event("dmmt.host_tables", base + 240, base + 244),
                   Event("dmmt.pack_wait", base + 250, base + 290),
                   Event("dmmt.word_fetch", base + 290, base + 310),
                   Event("dmmt.stuff", base + 310, base + 470),
                   Event("dmmt.container", base + 470, base + 478)]
    run = Run(device="cuda")
    run.trace = t
    return run


@pytest.mark.parametrize("name, want_ms", [("hist_wait_ms.tile", 0.030),
                                           ("host_tables_ms.tile", 0.004),
                                           ("pack_wait_ms.tile", 0.040),
                                           ("word_fetch_ms.tile", 0.020),
                                           ("stuff_host_ms.tile", 0.160)])
def test_tail_readers_read_their_spans(name, want_ms):
    assert harness.reader(name)(tile_run()) == pytest.approx(want_ms)


@pytest.mark.parametrize("name", list(TAIL))
def test_tail_readers_find_nothing_without_the_programs_spans(name):
    run = tile_run()
    run.trace.host = [e for e in run.trace.host if not e.name.startswith("dmmt.")]
    assert harness.reader(name)(run) is None
    assert harness.reader(name)(Run(device="cuda")) is None


@pytest.mark.parametrize("name", list(TAIL))
def test_tail_readers_leave_out_a_span_the_program_lacks(name):
    """A program with the one-dispatch finish's spans but not these (one
    older than them) gives nothing, not 0: the line leaves the metric out."""
    run = tile_run()
    run.trace.host = [e for e in run.trace.host if e.name != TAIL[name]]
    assert harness.reader(name)(run) is None
