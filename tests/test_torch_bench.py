"""The port's bench stage (dmmt_jpeg_encoder_tpu_torch/bench.py) on the CPU.

The supervisor against stub children (the cases of test_bench_supervisor.py
for the JAX bench.py, plus a failed stage and a failed candidate, which make
the port's run exit non-zero), the frame generator against the test
fixtures', and a whole run at 48x32 with --device cpu, whose stages run the
kernels' plain versions and whose e2e JPEG must equal the JAX package's."""

import argparse
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import dmmt_jpeg_encoder_tpu as dj
from dmmt_jpeg_encoder_tpu_torch import bench
from torch_port_fixtures import _pixels, sha256

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(width=48, height=32)
# the metrics of a run whose frame is shorter than every slab slice,
# without the 8K stage
SMALL_RUN_METRICS = [m for m in bench.METRIC_ORDER if not m.startswith(("8k_", "4k_n"))]


def _stub(tmp_path: Path, body: str) -> list:
    p = tmp_path / "stub_child.py"
    p.write_text(textwrap.dedent(body))
    return [sys.executable, str(p)]


def _json_lines(text: str) -> list[dict]:
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def _patch_child(monkeypatch, stub: Path) -> None:
    """Make the supervisor spawn `stub` in place of the bench child, with
    no backoff."""
    real_run = bench._run_attempt
    monkeypatch.setattr(bench, "_run_attempt",
                        lambda cmd, t, m, label="": real_run([sys.executable, str(stub)], t, m, label))
    monkeypatch.setattr(bench.time, "sleep", lambda s: None)


def test_harvests_json_lines_and_streams(tmp_path, capsys):
    cmd = _stub(tmp_path, """
        import json, sys
        print("devices: stub")  # non-JSON noise goes to stderr
        print("child diagnostics", file=sys.stderr)
        print(json.dumps({"metric": "4k_rgb_to_jpeg_throughput",
                          "value": 1.0, "unit": "Mpix/s", "vs_baseline": 0.001}))
        print(json.dumps({"metric": "4k_device_program_throughput",
                          "value": 2.0, "unit": "Mpix/s", "vs_baseline": 0.002}))
        """)
    metrics = {}
    assert bench._run_attempt(cmd, 60, metrics, "card, 1 W") == 0
    assert set(metrics) == {"4k_rgb_to_jpeg_throughput", "4k_device_program_throughput"}
    out = capsys.readouterr()
    assert "devices: stub" not in out.out
    assert '"4k_device_program_throughput"' in out.out
    # every stderr line starts with the card's name and power limit; the
    # child's stdout noise and its stderr reach stderr from two reader
    # threads, so their order is not defined
    lines = out.err.splitlines()
    assert all(line.startswith("card, 1 W | ") for line in lines)
    assert len(lines) == 2
    assert set(lines) == {"card, 1 W | devices: stub", "card, 1 W | child diagnostics"}


def test_partial_metrics_survive_child_crash(tmp_path):
    cmd = _stub(tmp_path, """
        import json, sys
        print(json.dumps({"metric": "4k_rgb_to_jpeg_throughput",
                          "value": 3.0, "unit": "Mpix/s", "vs_baseline": 0.003}), flush=True)
        sys.exit(7)  # crash after the first stage
        """)
    metrics = {}
    assert bench._run_attempt(cmd, 60, metrics) == 7
    assert metrics["4k_rgb_to_jpeg_throughput"]["value"] == 3.0


def test_timeout_kills_hung_child(tmp_path):
    cmd = _stub(tmp_path, """
        import json, time
        print(json.dumps({"metric": "4k_rgb_to_jpeg_throughput",
                          "value": 4.0, "unit": "Mpix/s", "vs_baseline": 0.004}), flush=True)
        time.sleep(3600)
        """)
    metrics = {}
    assert bench._run_attempt(cmd, 3, metrics) is None  # timed out, killed by its PID
    assert metrics["4k_rgb_to_jpeg_throughput"]["value"] == 4.0


def test_metric_order_puts_program_floor_last():
    assert bench.METRIC_ORDER[-1] == "4k_device_program_throughput"
    assert len(set(bench.METRIC_ORDER)) == 10


def test_supervisor_retries_and_orders(tmp_path, monkeypatch, capsys):
    """Attempt 1 dies before any stage, attempt 2 completes: one retry, and
    the last line is the final device-program metric of attempt 2."""
    marker = tmp_path / "attempt_count"
    stub = tmp_path / "flaky_child.py"
    stub.write_text(textwrap.dedent(f"""
        import json, pathlib, sys
        m = pathlib.Path({str(marker)!r})
        n = int(m.read_text()) if m.exists() else 0
        m.write_text(str(n + 1))
        if n == 0:
            sys.stderr.write("CUDA error: initialization error\\n")
            sys.exit(1)
        for metric, v in [("4k_device_program_throughput", 20.0),
                          ("4k_rgb_to_jpeg_throughput", 10.0)]:
            print(json.dumps({{"metric": metric, "value": v, "unit": "Mpix/s",
                               "vs_baseline": v / 1000}}), flush=True)
        """))
    _patch_child(monkeypatch, stub)
    rc = bench.main(["--attempts", "3", "--attempt-timeout", "30", "--device", "cpu"])
    assert rc == 0
    lines = _json_lines(capsys.readouterr().out)
    finals = [x for x in lines if x.get("final")]
    assert [x["metric"] for x in finals] == ["4k_rgb_to_jpeg_throughput",
                                             "4k_device_program_throughput"]
    assert lines[-1]["metric"] == "4k_device_program_throughput" and lines[-1]["value"] == 20.0
    assert marker.read_text() == "2"  # exactly one retry


def test_all_attempts_failing_returns_rc1(tmp_path, monkeypatch):
    stub = tmp_path / "dead_child.py"
    stub.write_text("import sys; sys.exit(1)\n")
    _patch_child(monkeypatch, stub)
    assert bench.main(["--attempts", "2", "--attempt-timeout", "30", "--device", "cpu"]) == 1


@pytest.mark.parametrize("attempts", [1, 2])
def test_failed_stage_makes_run_exit_nonzero(tmp_path, monkeypatch, capsys, attempts):
    """A child that emits every metric but counts a failed stage exits 1:
    the supervisor re-emits what it saw and still exits non-zero."""
    stub = tmp_path / "stage_failed_child.py"
    stub.write_text(textwrap.dedent("""
        import json, sys
        for metric in ("4k_rgb_to_jpeg_throughput", "4k_device_program_throughput"):
            print(json.dumps({"metric": metric, "value": 1.0, "unit": "Mpix/s",
                              "vs_baseline": 0.001}), flush=True)
        print("stage batch FAILED:", file=sys.stderr)
        sys.exit(1)
        """))
    _patch_child(monkeypatch, stub)
    rc = bench.main(["--attempts", str(attempts), "--attempt-timeout", "30", "--device", "cpu"])
    assert rc == 1
    out = capsys.readouterr()
    assert [x["metric"] for x in _json_lines(out.out) if x.get("final")] == [
        "4k_rgb_to_jpeg_throughput", "4k_device_program_throughput"]
    assert "no attempt finished without a failed stage" in out.err


def _args(**kw) -> argparse.Namespace:
    """A child's arguments: the small frame on the CPU, the host-path
    stages, 8K and slab off (the tests below turn on what they need)."""
    base = dict(rounds=1, batch=2, preset="P420", seed=0, device="cpu", device_only=True,
                no_8k=True, no_slab=True, **SMALL)
    return argparse.Namespace(**{**base, **kw})


def test_failed_candidate_is_a_failure(monkeypatch, capsys):
    """A sweep candidate whose floor raises is counted: the child exits 1,
    the other candidates and the later stages still run."""
    real = bench._floor_single

    def floor(dev_px, *a, **kw):
        if os.environ.get("DMMT_P1") == "fused1":
            raise RuntimeError("candidate failed")
        return real(dev_px, *a, **kw)

    monkeypatch.setattr(bench, "_floor_single", floor)
    run = bench._Bench(_args())
    assert run.run() == 1
    assert run.failures == ["mode-sweep fused1/fused-hist", "mode-sweep fused1/matmul-hist"]
    metrics = [x["metric"] for x in _json_lines(capsys.readouterr().out)]
    assert metrics == ["4k_bitexact_program_throughput", "4k_device_program_throughput",
                       "4k_device_only_throughput"]


def test_byte_mismatch_fails_the_stage(monkeypatch, capsys):
    """A candidate whose JPEG differs from its reference fails, and so does
    a stage; isolation keeps the later stages running."""
    real = bench._Bench.reference

    def reference(self, frame, p1="plane", hist="fused"):
        return "0" * 64 if p1 == "fused2" else real(self, frame, p1, hist)

    def device_only(self):
        raise RuntimeError("stage failed")

    monkeypatch.setattr(bench._Bench, "reference", reference)
    monkeypatch.setattr(bench._Bench, "_bench_device_only", device_only)
    run = bench._Bench(_args(device_only=False))
    assert run.run() == 1
    assert run.failures == ["mode-sweep fused2/fused-hist", "mode-sweep fused2/matmul-hist",
                            "device-only"]
    metrics = [x["metric"] for x in _json_lines(capsys.readouterr().out)]
    assert "4k_device_only_throughput" not in metrics
    assert metrics[-2:] == ["4k_rgb_to_jpeg_throughput", "4k_rgb_to_jpeg_batch_throughput"]


def test_slab_depth_past_the_group_bound_raises(monkeypatch):
    """The slab stage never shrinks B: a 32x48 P420 image holds 36 blocks,
    so a bound of 100 takes two images and refuses three."""
    monkeypatch.setenv("DMMT_SLAB_MAX_BLOCKS", "100")
    run = bench._Bench(_args())
    stack, frames = run.slab_stack(2, 32)
    assert tuple(stack.shape) == (2, 32, 48, 3) and frames == [("roll", 0, 32), ("roll", 13, 32)]
    with pytest.raises(ValueError, match="group bound"):
        run.slab_stack(3, 32)


@pytest.mark.parametrize("h, w, maxval, seed", [(1, 1, 255, 0), (7, 17, 255, 2), (32, 48, 255, 0),
                                                (123, 205, 4095, 3)])
def test_frame_generator_equals_the_fixtures(h, w, maxval, seed):
    np.testing.assert_array_equal(bench.frame_pixels(h, w, maxval, seed), _pixels(h, w, maxval, seed))


def test_modes_restores_the_environment(monkeypatch):
    monkeypatch.setenv("DMMT_P1", "mxu")
    monkeypatch.delenv("DMMT_HIST", raising=False)
    with bench._modes("fused1", "matmul"):
        assert (os.environ["DMMT_P1"], os.environ["DMMT_HIST"]) == ("fused1", "matmul")
    assert os.environ["DMMT_P1"] == "mxu" and "DMMT_HIST" not in os.environ


def test_emit_reports_median_min_max(capsys):
    bench._emit("4k_device_only_throughput", [3.0, 1.0, 2000.0], ms=1.5)
    line = json.loads(capsys.readouterr().out)
    assert line == {"metric": "4k_device_only_throughput", "value": 3.0, "unit": "Mpix/s",
                    "vs_baseline": 0.003, "min": 1.0, "max": 2000.0, "rounds": 3, "ms": 1.5}


def test_cpu_run_end_to_end():
    """The whole bench at 48x32 on the CPU: exit 0, every metric but the 8K
    and slab-mesh ones final and in order, the slab slices skipped for
    geometry, and the e2e JPEG equal to the JAX package's."""
    proc = subprocess.run(
        [sys.executable, "-m", "dmmt_jpeg_encoder_tpu_torch.bench", "--device", "cpu",
         "--width", "48", "--height", "32", "--rounds", "1", "--batch", "2", "--no-8k"],
        cwd=REPO, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    finals = [x for x in _json_lines(proc.stdout) if x.get("final")]
    assert [x["metric"] for x in finals] == SMALL_RUN_METRICS
    assert all(x["value"] > 0 and x["rounds"] == 1 for x in finals)
    err = proc.stderr.splitlines()
    assert all(line.startswith("cpu | ") for line in err)
    assert sum("skipped (bench height 32 < slice)" in line for line in err) == 3
    assert not any("FAILED" in line for line in err)
    px = bench.frame_pixels(32, 48)
    want = dj.encode_array(px, 255, dj.EncoderConfig(
        chroma_subsampling=dj.ChromaSubsamplingPreset.P420))
    e2e = next(x for x in finals if x["metric"] == "4k_rgb_to_jpeg_throughput")
    assert e2e["jpeg_sha256"] == sha256(want)
