"""The camera-raw cell (`gfx100_p444_q95.photo`) on the CPU: its
configuration and pool of exactly two 16-bit frames, the roofline
arithmetic of its kernels at 11648x8736 (perfbench/wide_roofline.py),
its four readers on a synthetic trace and without what they read, and a
rehearsal of the cell."""

import json
import subprocess
import sys

import pytest

from perfbench import harness, roofline, wide_roofline
from perfbench.harness import Run
from perfbench.trace import Event, Trace

CELL = "gfx100_p444_q95.photo"
READERS = ["fetch_wait_ms.photo", "phase1_roofline.photo", "scan_pack_roofline.photo",
           "scan_stuff_roofline.photo"]
H, W = 8736, 11648
K1 = ("void (anonymous namespace)::phase1_kernel<1, 1, unsigned short>(unsigned short const*, "
      "int, int)")
K1_8BIT = "void (anonymous namespace)::phase1_kernel<1, 1, unsigned char>(unsigned char const*, int)"
K3 = "(anonymous namespace)::pack_kernel(short const*, long long, int)"
K13 = "(anonymous namespace)::stuff_kernel(unsigned char*, long long, long long const*)"
SCAN_BITS = 528_000_000  # a 66 MB stream


def test_the_configuration_and_the_pool_of_two_frames():
    cell = harness.Cell.load(CELL)
    assert (cell.config["height"], cell.config["width"], cell.maxval) == (H, W, 65535)
    assert (cell.config["chroma_subsampling"], cell.config["quality"]) == ("P444", 95)
    assert cell.chips == 1 and cell.traffic["call"] == "encode_array"
    assert cell.traffic["batch"] == 1 and cell.traffic.get("callers", 1) == 1
    assert "rate" not in cell.traffic
    assert cell.traffic["pool_min_bytes"] == H * W * 3 * 2
    assert harness.pool_size(cell.traffic, H, W) == 2
    assert (cell.traffic["warm_requests"], cell.traffic["trace_requests"]) == (2, 16)
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    (conf,) = [c for c in bench["configs"] if c["name"] == "gfx100_p444_q95"]
    assert conf["reduced"] == [] and len(conf["source"]) <= 200


def test_the_cell_reports_its_metrics():
    cell = harness.Cell.load(CELL)
    assert [m["name"] for m in cell.end_to_end] == ["encode_mpix_s", "device_peak_gib", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == READERS
    assert all(m["moves"] == "encode_mpix_s" for m in cell.per_layer)


def test_p444_has_no_subsampling():
    assert harness._rates("P444") == (1, 1)


def test_phase1_least_time_of_a_16_bit_444_frame():
    """Bytes bound: 610,541,568 bytes of samples, 4,769,856 blocks of 128
    bytes and 512 of tables over 3.35 TB/s; 54.5 operations a pixel."""
    assert roofline.blocks_per_image(H, W, 1, 1) == 4_769_856
    assert wide_roofline.phase1_ops_per_pixel(1, 1) == 54.5
    n_bytes = H * W * 3 * 2 + 4_769_856 * 128 + 512
    assert n_bytes / roofline.PEAK_BYTES_S > H * W * 54.5 / roofline.PEAK_OPS_S
    assert wide_roofline.phase1_seconds(H, W, 1, 1, 2) == pytest.approx(n_bytes / 3.35e12)
    assert wide_roofline.phase1_seconds(H, W, 1, 1, 2) * 1e3 == pytest.approx(0.3645, abs=5e-5)


def test_scan_pack_and_stuffing_least_times():
    words = (SCAN_BITS + 31) // 32
    pack = (4_769_856 * 128 + 2 * 4 * 256 * 4 + 8 + words * 4) / 3.35e12
    assert roofline.scan_pack_seconds(H, W, 1, 1, SCAN_BITS) == pytest.approx(pack)
    assert wide_roofline.stuff_seconds(SCAN_BITS) == pytest.approx(2 * 66_000_000 / 3.35e12)
    assert wide_roofline.stuff_seconds(9) == pytest.approx(4 / 3.35e12)  # 2 bytes each way


def test_sample_width_from_the_kernels_name():
    assert wide_roofline.sample_bytes(K1) == 2 and wide_roofline.sample_bytes(K1_8BIT) == 1


def photo_run() -> Run:
    """Two requests in a 1,000 us stretch, one replay each, with their
    finish's spans; a third request's spans lie past the stretch's end."""
    t = Trace(requests=2, images=2, start=0.0, end=1000.0, shape=(H, W, 1, 1),
              scan_bits=[SCAN_BITS, SCAN_BITS], graph_launches={1, 2})
    t.host = [Event("request", 0, 480), Event("request", 500, 1000)]
    for base in (0, 500, 1000):
        t.host += [Event("dmmt.fill", base, base + 200),
                   Event("dmmt.word_fetch", base + 300, base + 340),
                   Event("dmmt.fetch_wait", base + 310, base + 336),
                   Event("dmmt.stuff", base + 340, base + 360)]
    t.kernels = [Event(K1, 210, 212, 1), Event(K3, 220, 221, 1), Event(K13, 222, 222.5, 1),
                 Event(K1, 710, 712, 2), Event(K3, 720, 721, 2), Event(K13, 722, 722.5, 2)]
    run = Run(device="cuda")
    run.trace = t
    return run


def test_readers_on_a_synthetic_trace():
    run = photo_run()
    assert harness.reader("fetch_wait_ms.photo")(run) == pytest.approx(0.026)
    k1 = 100.0 * wide_roofline.phase1_seconds(H, W, 1, 1, 2) / 2e-6
    assert harness.reader("phase1_roofline.photo")(run) == pytest.approx(k1)
    k3 = 100.0 * roofline.scan_pack_seconds(H, W, 1, 1, SCAN_BITS) / 1e-6
    assert harness.reader("scan_pack_roofline.photo")(run) == pytest.approx(k3)
    k13 = 100.0 * wide_roofline.stuff_seconds(SCAN_BITS) / 0.5e-6
    assert harness.reader("scan_stuff_roofline.photo")(run) == pytest.approx(k13)


def test_phase1_reader_counts_8_bit_samples_from_an_8_bit_kernel():
    run = photo_run()
    for k in run.trace.kernels:
        if k.name == K1:
            k.name = K1_8BIT
    k1 = 100.0 * wide_roofline.phase1_seconds(H, W, 1, 1, 1) / 2e-6
    assert harness.reader("phase1_roofline.photo")(run) == pytest.approx(k1)


@pytest.mark.parametrize("name, lacks", [("fetch_wait_ms.photo", "dmmt.fetch_wait"),
                                         ("phase1_roofline.photo", K1),
                                         ("scan_pack_roofline.photo", K3),
                                         ("scan_stuff_roofline.photo", K13)])
def test_each_reader_finds_nothing_without_what_it_reads(name, lacks):
    """A program without the span or the kernel (the parent's has no
    dmmt.fetch_wait; one that stuffs on the host no stuff_kernel) gives
    nothing, not 0: the line leaves the metric out."""
    run = photo_run()
    run.trace.host = [e for e in run.trace.host if e.name != lacks]
    run.trace.kernels = [k for k in run.trace.kernels if k.name != lacks]
    assert harness.reader(name)(run) is None
    assert harness.reader(name)(Run(device="cuda")) is None


def test_rehearsal_of_the_cell():
    """The cell on the CPU at the harness's 40x56 rehearsal shape: uint16
    frames through encode_array, every JPEG equal to the reference's."""
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", CELL, "--seed",
                           str(2**33 + 1), "--seconds", "0.5", "--trace", "0", "--rehearse"],
                          cwd=harness.ROOT, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"encode_mpix_s", "setup_s"}
    assert "2 frames of 40x56 made" in proc.stderr
