"""The trace reductions on a synthetic trace: kernel names, replays grouped
by their graph launch, the per-layer readers and the breakdown's labels."""

import json

import pytest

from perfbench import readers, roofline
from perfbench.harness import Run
from perfbench.trace import Event, Trace, breakdown, is_port_kernel, kernel_base, read_chrome_trace

K1 = "void (anonymous namespace)::phase1_kernel<2, 2, unsigned char>(unsigned char const*, int)"
K3 = "(anonymous namespace)::pack_kernel(short const*, long long, int)"
K7 = "void (anonymous namespace)::pack_kernel<true>(int const*, int)"
TORCH = "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<int> >(int)"


@pytest.mark.parametrize("name, base, port", [(K1, "phase1_kernel", True), (K3, "pack_kernel", True),
                                              (K7, "pack_kernel", True),
                                              (TORCH, "vectorized_elementwise_kernel", False)])
def test_kernel_names(name, base, port):
    assert kernel_base(name) == base and is_port_kernel(name) is port


def synthetic() -> Run:
    """Two requests of one replay each (launch correlations 1 and 2), on a
    4K frame, in a 100 us stretch."""
    t = Trace(requests=2, images=2, start=0.0, end=100.0, shape=(2160, 3840, 2, 2),
              scan_bits=[4_000_000, 4_000_000], graph_launches={1, 2}, graph_bytes=3 << 20)
    t.kernels = [Event(K1, 0, 10, 1), Event(TORCH, 12, 20, 1), Event(K3, 22, 30, 1),
                 Event(K1, 50, 60, 2), Event(TORCH, 62, 70, 2), Event(K3, 72, 80, 2)]
    t.spans.update(start=0.004, finish=0.002, jpeg=0.001)
    run = Run(device="cuda")
    run.trace = t
    return run


def test_readers_on_a_synthetic_trace():
    run = synthetic()
    assert readers.replay_device_ms(run) == pytest.approx(0.030)  # 30 us per replay
    assert readers.torch_ops_ms(run) == pytest.approx(0.008)
    assert readers.device_idle_pct(run) == pytest.approx(48.0)  # 52 of 100 us busy
    assert readers.span_ms(run, "finish", "jpeg") == pytest.approx(1.5)
    assert readers.span_ms(run, "upload") is None
    assert readers.phase1_roofline(run) == pytest.approx(
        100 * 2 * roofline.phase1_seconds(2160, 3840, 2, 2) / 20e-6)
    assert readers.scan_pack_roofline(run) == pytest.approx(
        100 * 2 * roofline.scan_pack_seconds(2160, 3840, 2, 2, 4_000_000) / 16e-6)


def test_readers_find_nothing_without_a_trace():
    run = Run(device="cpu")
    for read in (readers.replay_device_ms, readers.torch_ops_ms, readers.device_idle_pct,
                 readers.phase1_roofline, readers.scan_pack_roofline):
        assert read(run) is None


def test_breakdown_names_idle_time_by_host_activity():
    t = Trace(start=0.0, end=100.0)
    t.kernels = [Event("k1", 0, 10), Event("k2", 50, 60)]
    t.host = [Event("request", 0, 45), Event("request", 55, 100), Event("finish", 5, 30),
              Event("cudaEventSynchronize", 12, 28)]
    out = breakdown(t)
    assert dict(out["idle_gaps"]) == {"finish": 40e-6, "request, outside the spans": 40e-6}
    assert dict(out["device_ops"]) == {"k1": 10e-6, "k2": 10e-6}


def test_read_chrome_trace(tmp_path):
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "request", "tid": 7, "ts": 100, "dur": 50},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "tid": 7, "ts": 110,
         "dur": 5, "args": {"correlation": 9}},
        {"ph": "X", "cat": "kernel", "name": K1, "tid": 3, "ts": 120, "dur": 4,
         "args": {"correlation": 9}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)", "tid": 3,
         "ts": 101, "dur": 6},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "tid": 8, "ts": 100, "dur": 3},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    t = Trace()
    read_chrome_trace(str(path), t)
    assert (t.start, t.end) == (100.0, 150.0)
    assert [len(r) for r in t.replays()] == [1] and len(t.copies) == 1
    assert [e.name for e in t.host] == ["request", "cudaGraphLaunch"]  # other threads left out


def test_replays_read_nothing_without_graph_launches():
    """Kernels the trace cannot tie to a graph launch give no program time,
    so a trace that lost its replays shows at once."""
    run = synthetic()
    run.trace.graph_launches = set()
    assert readers.replay_device_ms(run) is None and readers.torch_ops_ms(run) is None
    assert readers.device_idle_pct(run) == pytest.approx(48.0)
