"""The harness on the CPU: every cell rehearsed at a tiny frame size, the
check that decides `correct` against planted faults and the control, files
taken up by name, and no JAX anywhere."""

from __future__ import annotations

import ast
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from perfbench import control, harness

PERFBENCH = Path(__file__).resolve().parents[1]
ROOT = PERFBENCH.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def run_script(args, cwd=ROOT, env=None, timeout=240):
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)


def last_line(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_prints_a_result_line(cell):
    proc = run_script(["perfbench/run.py", "--workload", cell, "--seed", str(2**31 + 99),
                       "--seconds", "0.5", "--trace", "0", "--rehearse"])
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = last_line(proc.stdout)
    assert RESULT_KEYS <= set(result) and list(result)[-1] == "checks"
    assert result["correct"] is True and result["attempted"] > 0 and result["failed"] == 0
    expected = {m["name"] for m in harness.Cell.load(cell).end_to_end} - {"device_peak_gib"}
    assert set(result["metrics"]) == expected  # the device's peak is no CPU number
    assert result["device"]["platform"] == "cpu"
    assert proc.stderr.strip().splitlines()[-2:] == [
        "check wrong_jpegs: 0 (limit 0)", "check missing_jpegs: 0 (limit 0)"]


def test_traced_rehearsal_reports_no_device_metric():
    proc = run_script(["perfbench/run.py", "--workload", CELLS[0], "--seed", "3", "--seconds", "0.2",
                       "--trace", "1", "--rehearse"])
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = last_line(proc.stdout)
    assert result["correct"] is True and result["metrics"] == {} and "breakdown" not in result


def altered_byte(call):
    """An answer altered where it is produced: one byte of the first JPEG."""
    def broken(frames):
        out = call(frames)
        j = bytearray(out[0])
        j[len(j) // 2] ^= 0x10
        return [bytes(j), *out[1:]]
    return broken


def half_left_out(call):
    """Half of the batch left out: only the first half is encoded."""
    return lambda frames: call(frames[: max(1, len(frames) // 2)])


def state_unchanged(call):
    """A step that returns its state unchanged: every request gets the
    first request's JPEGs."""
    first = []

    def broken(frames):
        if not first:
            first.append(call(frames))
        return list(first[0])
    return broken


BATCH_CELLS = [c for c in CELLS if harness.Cell.load(c).traffic["batch"] > 1]
# a single-image request has no half to leave out
FAULT_CASES = [(c, f) for c in CELLS for f in (altered_byte, state_unchanged)] + \
    [(c, half_left_out) for c in BATCH_CELLS]


@pytest.mark.parametrize("cell, fault", FAULT_CASES)
def test_planted_fault_is_not_correct(cell, fault):
    result = harness.run_cell(harness.Cell.load(cell), 2**31 + 17, 0.3, False, time.monotonic(),
                              rehearse=True, program_hook=fault)
    assert result["correct"] is False and result["failed"] > 0
    assert result["checks"]["wrong_jpegs"]["value"] + result["checks"]["missing_jpegs"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    """The reference in bfloat16 in the program's place fails the check."""
    assert control.main(["--workload", cell, "--seeds", "5,6,7", "--seconds", "0.2",
                         "--rehearse"]) == 0


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


def test_no_module_imports_jax():
    """Top-level names compared whole: the port's name begins with the JAX
    package's."""
    files = sorted(PERFBENCH.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        found = _imports(path) & set(harness.BANNED)
        assert not found, f"{path} imports {found}"
    assert "dmmt_jpeg_encoder_tpu_torch" not in harness.BANNED


# a run's process with JAX loaded where the argument says, by a stub module
# named `jax`: in the judging (the reference), in a metric's reader, or
# nowhere
LOADS_JAX = """
import sys, time, types
sys.path.insert(0, {root!r})
from perfbench import harness, reference

def load_jax():
    sys.modules.setdefault("jax", types.ModuleType("jax"))

where = sys.argv[1]
if where == "judge":
    encode = reference.encode
    reference.encode = lambda *a, **kw: (load_jax(), encode(*a, **kw))[1]
elif where == "reader":
    reader = harness.reader
    harness.reader = lambda name: (load_jax(), reader(name))[1]
sys.exit(harness.main(["--workload", {cell!r}, "--seed", "8", "--seconds", "0.2", "--trace", "0",
                       "--rehearse"], time.monotonic()))
"""


@pytest.mark.parametrize("where", ["judge", "reader", "nowhere"])
def test_jax_loaded_after_the_window_gives_no_result(where):
    proc = run_script(["-c", LOADS_JAX.format(root=str(ROOT), cell=CELLS[0]), where])
    if where == "nowhere":
        assert proc.returncode == 0 and last_line(proc.stdout)["correct"] is True, proc.stderr[-2000:]
    else:
        assert proc.returncode == 2 and proc.stdout.strip() == ""
        assert "loaded in the run's process: jax" in proc.stderr


def test_banned_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "dmmt_jpeg_encoder_tpu_torch_extra", sys)
    assert "dmmt_jpeg_encoder_tpu" not in harness.banned_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", sys)
    assert "jaxlib" in harness.banned_modules()


def _digests(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in [root / "BENCHMARK.json", *sorted((root / "perfbench").rglob("*"))]
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_are_taken_up_by_name(tmp_path):
    """A configuration, a traffic mix and a metric, each one new file plus
    an entry in BENCHMARK.json: no file that was there changes."""
    shutil.copytree(PERFBENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(tmp_path)
    conf = json.loads((PERFBENCH / "configs" / "fhd1080_p420_q75.json").read_text())
    conf.update(name="sd480_p444_q90", width=640, height=480, chroma_subsampling="P444", quality=90,
                maxval=1023)
    (tmp_path / "perfbench" / "configs" / "sd480_p444_q90.json").write_text(json.dumps(conf))
    traffic = json.loads((PERFBENCH / "traffic" / "batch8.json").read_text())
    traffic.update(batch=3, callers=2, rate=40)
    (tmp_path / "perfbench" / "traffic" / "batch3.json").write_text(json.dumps(traffic))
    (tmp_path / "perfbench" / "metrics" / "requests_done.py").write_text(
        "def read(run):\n    return float(len(run.latencies_s))\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "sd480_p444_q90", "source": "test",
                             "file": "perfbench/configs/sd480_p444_q90.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "sd480_p444_q90.batch3", "config": "sd480_p444_q90",
                               "traffic": "batch3", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "requests_done", "unit": "requests", "better": "higher",
                                "bound": 0.01, "source": "host_clock",
                                "workloads": ["sd480_p444_q90.batch3"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digests(tmp_path)
    assert {k: after[k] for k in before if k != "BENCHMARK.json"} == \
        {k: v for k, v in before.items() if k != "BENCHMARK.json"}
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = run_script([str(tmp_path / "perfbench" / "run.py"), "--workload", "sd480_p444_q90.batch3",
                       "--seed", "4", "--seconds", "0.3", "--trace", "0", "--rehearse"],
                      cwd=tmp_path, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = last_line(proc.stdout)
    assert result["correct"] is True
    assert result["metrics"]["requests_done"]["value"] == result["attempted"]


def test_stripped_checkout_gives_no_result(tmp_path):
    """Only BENCHMARK.json and perfbench/: the program is missing, so the run
    exits non-zero and prints no result."""
    shutil.copytree(PERFBENCH, tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = run_script(["perfbench/run.py", "--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                       "--trace", "0"], cwd=tmp_path, env=env)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.card
def test_cell_on_the_card(card):
    proc = run_script(["perfbench/run.py", "--workload", CELLS[0], "--seed", str(2**31 + 1),
                       "--seconds", "2", "--trace", "0"], timeout=360)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = last_line(proc.stdout)
    assert result["correct"] is True and result["device"]["platform"] == "gpu"


def _rehearse_traffic(tmp_path, trace: int, **keys) -> dict:
    """A rehearsal of the 1080p configuration under a traffic file of the
    single mix with `keys` changed, written into a copy of the benchmark."""
    shutil.copytree(PERFBENCH, tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    traffic = json.loads((PERFBENCH / "traffic" / "single.json").read_text())
    traffic.update(keys)
    (tmp_path / "perfbench" / "traffic" / "mix.json").write_text(json.dumps(traffic))
    bench = dict(BENCH, workloads=[{"name": "fhd1080_p420_q75.mix", "config": "fhd1080_p420_q75",
                                    "traffic": "mix", "chips": 1, "why": "test"}])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    proc = run_script([str(tmp_path / "perfbench" / "run.py"), "--workload", "fhd1080_p420_q75.mix",
                       "--seed", "12", "--seconds", "0.5", "--trace", str(trace), "--rehearse"],
                      cwd=tmp_path, env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stderr[-2000:]
    return last_line(proc.stdout)


@pytest.mark.parametrize("keys, trace", [({"callers": 3}, 0), ({"callers": 3}, 1),
                                         ({"rate": 30}, 0), ({"callers": 2, "rate": 60}, 1)])
def test_callers_and_rate_are_taken_from_the_traffic_file(tmp_path, keys, trace):
    result = _rehearse_traffic(tmp_path, trace, **keys)
    assert result["correct"] is True and result["failed"] == 0
    if "rate" in keys:  # an open loop offers about rate x seconds requests
        assert result["attempted"] <= keys["rate"] * 0.5 + 1 + 50 * trace
    else:
        assert result["attempted"] >= keys["callers"]


def test_window_hands_out_slots_in_order():
    closed = harness.Window(0.0, None, 3)  # closed: only the traced slots
    closed.open()
    assert [closed.take() for _ in range(4)] == [(0, None), (1, None), (2, None), None]
    opened = harness.Window(0.05, 200.0, 0)  # open loop: a slot every 5 ms
    opened.open()
    slots = []
    while (slot := opened.take()) is not None:
        slots.append(slot)
    assert len(slots) == 10 and [k for k, _ in slots] == list(range(10))
    assert slots[-1][1] - slots[0][1] == pytest.approx(0.045)
    assert time.perf_counter() - slots[-1][1] >= 0  # no slot handed out before it fell due
