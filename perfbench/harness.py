"""The benchmark of the PyTorch/CUDA JPEG encoder: one cell per run.

    python3 perfbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Everything a cell is made of is found by name: the cell in BENCHMARK.json
names a configuration (its `file`: frame size, input `maxval`, encoder
settings) and a traffic mix (perfbench/traffic/<traffic>.json), and every
metric is a reader in perfbench/metrics/<name>.py. A traffic mix gives
the entry point (`call`: encode_array or encode_batch), the frames per
request (`batch`), the callers, each on a thread of its own (`callers`,
default 1), the requests per second offered in an open loop (`rate`;
without it each caller runs a closed loop), the frame pool's least size
(`pool_min_bytes`), the warm-up requests per caller (`warm_requests`) and
the requests of the traced stretch (`trace_requests`). A run makes its
frames from the seed, warms up every shape the cell uses, then sends
requests for S seconds and judges every JPEG after the window against the
plain reference's JPEG of its frame (perfbench/reference). With --trace 1
a short stretch at the start of the window is traced (perfbench/trace.py)
and the per-layer readers report; otherwise the end-to-end readers do.

The last line of standard output is the result: `correct`, `attempted`,
`failed`, `metrics`, `device` (and `breakdown` when traced), and last
`checks`, each number compared beside its limit; the same numbers are the
last lines of standard error. A run exits 2 and prints no result when it
finds no card (or fewer than the cell asks for), or when JAX or the JAX
package is loaded once the result is made, judging and readers included. `--rehearse` runs the cell
on the CPU at a tiny frame size, for the tests: its numbers are no device
measurement.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import math
import sys
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that may not be loaded in a run's process
BANNED = ("jax", "jaxlib", "flax", "dmmt_jpeg_encoder_tpu")
# the frame of a rehearsal (--rehearse): rows, columns
REHEARSAL_SHAPE = (40, 56)


class NoCard(RuntimeError):
    pass


@dataclass
class Cell:
    """One entry of BENCHMARK.json's workloads with what it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list

    @classmethod
    def load(cls, name: str, bench_path: Path = ROOT / "BENCHMARK.json") -> "Cell":
        bench = json.loads(bench_path.read_text())
        (cell,) = [w for w in bench["workloads"] if w["name"] == name]
        (conf,) = [c for c in bench["configs"] if c["name"] == cell["config"]]
        config = json.loads((ROOT / conf["file"]).read_text())
        traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())

        def mine(metrics):
            return [m for m in metrics if name in m.get("workloads", [name])]

        return cls(name, int(cell["chips"]), config, traffic, mine(bench["end_to_end"]),
                   mine(bench["per_layer"]))

    @property
    def maxval(self) -> int:
        """The input frames' largest sample value."""
        return int(self.config["maxval"])


def reader(name: str):
    """The `read` function of perfbench/metrics/<name>.py."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@dataclass
class Run:
    """What the readers read: the window's requests and the set-up."""

    setup_s: float = 0.0
    window_s: float = 0.0
    latencies_s: list = field(default_factory=list)   # per request, inf when it failed
    request_ok: list = field(default_factory=list)    # every JPEG of the request correct
    request_pixels: list = field(default_factory=list)
    memory_peak_bytes: int = 0
    trace: object = None
    device: str = "cpu"

    @property
    def pixels_ok(self) -> int:
        return sum(p for p, ok in zip(self.request_pixels, self.request_ok) if ok)


def encoder_config(dt, config: dict):
    """The program's EncoderConfig of a configuration file."""
    return dt.EncoderConfig(
        chroma_subsampling=dt.ChromaSubsamplingPreset(config["chroma_subsampling"]),
        quantization_preset=dt.QuantizationTablePreset[config["quantization_preset"]],
        quality=config["quality"],
        bits_per_channel=config["bits_per_channel"],
        dct_variant=dt.DCTVariant[config["dct_variant"]],
    )


def program_call(dt, cell: Cell, device: str):
    """frames -> JPEGs through the entry point the traffic names."""
    config = encoder_config(dt, cell.config)
    if cell.traffic["call"] == "encode_array":
        return lambda frames: [dt.encode_array(frames[0], cell.maxval, config, device=device)]
    if cell.traffic["call"] == "encode_batch":
        return lambda frames: dt.encode_batch(frames, cell.maxval, config, device=device)
    raise ValueError(f"unknown call {cell.traffic['call']!r}")


def pool_size(traffic: dict, height: int, width: int) -> int:
    """Distinct frames: at least one request's worth, and at least
    pool_min_bytes of samples."""
    return max(int(traffic["batch"]), math.ceil(traffic["pool_min_bytes"] / (height * width * 3)))


class Schedule:
    """Which pool frames a caller's requests take, from the seed and the
    caller's number: every request of a batch mix a permutation of `batch`
    distinct frames; single requests run through one permutation of the
    pool after another."""

    def __init__(self, n_pool: int, batch: int, seed: int, caller: int = 0):
        self.n, self.batch = n_pool, batch
        self.rng = np.random.default_rng((int(seed), 7, caller))
        self.queue: list[int] = []

    def next(self) -> list[int]:
        if self.batch > 1:
            return [int(i) for i in self.rng.permutation(self.n)[: self.batch]]
        if not self.queue:
            self.queue = [int(i) for i in self.rng.permutation(self.n)]
        return [self.queue.pop()]


def banned_modules() -> list[str]:
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)} & set(BANNED))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Outputs:
    """Every JPEG of the window, kept as the distinct JPEGs of each frame:
    a JPEG equal to one kept for its frame is counted by the index of that
    one (one memcmp), any other is kept beside it. Each request keeps its
    frames and the index of each of its JPEGs, or None when it failed."""

    def __init__(self):
        self.kept: dict[int, list[bytes]] = {}
        self.requests: list[tuple[list[int], list[int] | None]] = []

    def __len__(self) -> int:
        return len(self.requests)

    def add(self, idx: list[int], jpegs) -> None:
        if not isinstance(jpegs, list):
            self.requests.append((idx, None))
            return
        which = []
        for i, jpeg in zip(idx, jpegs):
            kept = self.kept.setdefault(i, [])
            k = next((k for k, other in enumerate(kept) if other == jpeg), None)
            if k is None:
                kept.append(bytes(jpeg))
                k = len(kept) - 1
            which.append(k)
        self.requests.append((idx, which + [-1] * max(0, len(jpegs) - len(idx))))


def judge(outputs: Outputs, pool: list, cell: Cell, device: str) -> tuple[list[bool], dict]:
    """Hold every JPEG of the window against the reference's JPEG of its
    frame. Returns (per request: all its JPEGs right, the numbers compared:
    JPEGs that differ, frames that got no JPEG or JPEGs beyond the frames)."""
    from perfbench import reference

    right = {i: [jpeg == ref for jpeg in kept] for i, kept in outputs.kept.items()
             for ref in [reference.encode(pool[i], cell.maxval, cell.config, device=device)]}
    wrong = missing = 0
    ok = []
    for idx, which in outputs.requests:
        which = which if which is not None else []
        bad = sum(1 for i, k in zip(idx, which) if not right[i][k])
        short = abs(len(idx) - len(which))
        wrong, missing = wrong + bad, missing + short
        ok.append(bad == 0 and short == 0)
    return ok, {"wrong_jpegs": wrong, "missing_jpegs": missing}


LIMITS = {"wrong_jpegs": 0, "missing_jpegs": 0}


class Window:
    """The measured window's request slots, handed to the callers in order.
    Slot k is taken while the window is open: in a closed loop (the traffic
    names no `rate`) at once by the next free caller; in an open loop when
    it falls due, k / rate seconds into the window, and only if it falls
    due before the window closes; its latency then counts from when it fell
    due. The first `n_traced` slots are taken in any case, and no later
    slot is handed out until the traced stretch has been closed, so that
    stretch holds the traced requests alone."""

    def __init__(self, seconds: float, rate, n_traced: int):
        self.seconds, self.rate, self.n_traced = seconds, rate, n_traced
        self.lock = threading.Lock()
        self.next = 0
        self.pending = n_traced  # traced requests not yet back
        self.traced_back = threading.Event()
        self.closed = threading.Event()  # the traced stretch is closed
        if not n_traced:
            self.traced_back.set()
            self.closed.set()
        self.start = time.perf_counter()

    def open(self) -> None:
        self.start = time.perf_counter()

    def take(self):
        """(slot, when it fell due or None in a closed loop), or None once
        the window has closed."""
        with self.lock:
            k = self.next
            end = self.start + self.seconds
            due = self.start + k / self.rate if self.rate else None
            if k >= self.n_traced and (time.perf_counter() >= end or (due or 0.0) >= end):
                return None
            self.next += 1
        if k >= self.n_traced:
            self.closed.wait()
        wait = due - time.perf_counter() if due is not None else 0.0
        if wait > 0:
            time.sleep(wait)
        return k, due

    def back(self, k: int) -> bool:
        """Request k came back; True when it was the last traced one."""
        if k >= self.n_traced:
            return False
        with self.lock:
            self.pending -= 1
            return self.pending == 0


def each_caller(callers: int, fn, meanwhile=None) -> None:
    """fn(c) for every caller c, each on a thread of its own, and
    meanwhile() on the calling thread; one caller runs on the calling
    thread, and meanwhile is not called."""
    if callers == 1:
        fn(0)
        return
    errors = []

    def guarded(c):
        try:
            fn(c)
        except BaseException as exc:  # re-raised on the calling thread
            errors.append(exc)

    threads = [threading.Thread(target=guarded, args=(c,)) for c in range(callers)]
    for t in threads:
        t.start()
    if meanwhile is not None:
        meanwhile()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


def run_cell(cell: Cell, seed: int, seconds: float, trace_on: bool, t0: float,
             rehearse: bool = False, program_hook=None) -> dict:
    """Set up, run the window, judge; the result line's object."""
    import torch

    log(f"set-up: torch imported at {time.monotonic() - t0:.3f} s")

    if rehearse:
        device = "cpu"
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            raise NoCard(f"the cell asks for {cell.chips} card(s); torch sees "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = "cuda"
        torch.cuda.init()
        log(f"set-up: CUDA initialised at {time.monotonic() - t0:.3f} s")
    import dmmt_jpeg_encoder_tpu_torch as dt
    from dmmt_jpeg_encoder_tpu_torch import encoder as encoder_module
    from perfbench import frames, trace as tracing

    log(f"set-up: program imported at {time.monotonic() - t0:.3f} s")

    traffic = cell.traffic
    batch, callers = int(traffic["batch"]), int(traffic.get("callers", 1))
    height, width = REHEARSAL_SHAPE if rehearse else (cell.config["height"], cell.config["width"])
    n_pool = max(batch, 2) if rehearse else pool_size(traffic, height, width)
    pool = frames.frame_pool(height, width, n_pool, seed, device, cell.maxval)
    log(f"set-up: {n_pool} frames of {height}x{width} made at {time.monotonic() - t0:.3f} s")
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    call = program_call(dt, cell, device)
    if program_hook is not None:
        call = program_hook(call)
    schedules = [Schedule(n_pool, batch, seed, c) for c in range(callers)]

    def warm(c):
        for _ in range(int(traffic["warm_requests"])):
            call([pool[i] for i in schedules[c].next()])

    each_caller(callers, warm)
    on_card_trace = trace_on and device == "cuda"
    if on_card_trace:
        with _profiler(torch, callers):  # the profiler's own first start, outside the window
            call([pool[i] for i in schedules[0].next()])
    gc.collect()
    log(f"set-up: warm-up done at {time.monotonic() - t0:.3f} s")
    run = Run(device=device)
    outputs = Outputs()
    traced = tracing.Trace() if trace_on else None
    window = Window(seconds, traffic.get("rate"), int(traffic["trace_requests"]) if trace_on else 0)
    tracing_now = contextlib.ExitStack()
    held = []  # the traced requests' (frames, JPEGs), judged after the stretch
    lock = threading.Lock()

    def close_trace():
        tracing_now.close()
        traced.requests = window.n_traced
        traced.images = sum(len(idx) for idx, _ in held)
        traced.scan_bits = [_scan_bits(j) for _, jpegs in held if jpegs for j in jpegs]
        for request in held:
            outputs.add(*request)
        held.clear()
        window.closed.set()

    def serve(c):
        try:
            serve_requests(c)
        except BaseException:
            window.traced_back.set()  # so that no thread waits on the stretch
            raise

    def serve_requests(c):
        while (slot := window.take()) is not None:
            k, due = slot
            idx = schedules[c].next()
            batch_frames = [pool[i] for i in idx]
            begin = time.perf_counter() if due is None else due
            try:
                if k < window.n_traced:
                    with torch.profiler.record_function("request"):
                        jpegs = call(batch_frames)
                else:
                    jpegs = call(batch_frames)
                latency = time.perf_counter() - begin
            except Exception as exc:  # a failed request counts as missing
                log(f"request {k} failed: {exc!r}")
                jpegs, latency = None, math.inf
            with lock:
                if k < window.n_traced:
                    held.append((idx, jpegs))  # kept out of the traced stretch
                else:
                    outputs.add(idx, jpegs)
                run.latencies_s.append(latency)
                run.request_pixels.append(len(idx) * height * width)
            if window.back(k):
                if callers == 1:
                    close_trace()  # on the thread that opened the stretch
                else:
                    window.traced_back.set()

    window.open()
    run.setup_s = time.monotonic() - t0
    if on_card_trace:
        tracing_now.enter_context(tracing.spans_on(encoder_module, traced, torch))
        tracing_now.enter_context(prof := _profiler(torch, callers))
    else:
        prof = None

    def close_when_back():
        window.traced_back.wait()
        close_trace()

    each_caller(callers, serve, close_when_back if traced is not None else None)
    run.window_s = time.perf_counter() - window.start
    if device == "cuda":
        torch.cuda.synchronize()
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
    if traced is not None:
        traced.graph_bytes = dt.onedispatch.graph_bytes()
        traced.shape = (height, width, *_rates(cell.config["chroma_subsampling"]))
        if prof is not None:
            tracing.export(prof, traced)
            log(f"trace: {len(traced.kernels)} kernels, {len(traced.replays())} graph replays "
                f"holding {sum(map(len, traced.replays()))} of them, device ms "
                f"{sum(traced.replay_ms()):.4f}")
        run.trace = traced
    judged = time.monotonic()
    run.request_ok, checks = judge(outputs, pool, cell, device)
    lat = sorted(run.latencies_s)
    log(f"window: {len(lat)} requests in {run.window_s:.3f} s; latency ms min / quartiles / max "
        f"{' / '.join(f'{x * 1e3:.3f}' for x in (lat[0], *_quartiles(lat), lat[-1]))}; "
        f"judged in {time.monotonic() - judged:.3f} s")
    wanted = cell.per_layer if trace_on else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": all(checks[k] <= LIMITS[k] for k in LIMITS),
        "attempted": len(outputs),
        "failed": sum(1 for ok in run.request_ok if not ok),
        "metrics": metrics,
        "device": _device(torch, device, run, traced),
    }
    if traced is not None and traced.kernels:
        result["breakdown"] = tracing.breakdown(traced)
    result["checks"] = {k: {"value": v, "limit": LIMITS[k]} for k, v in checks.items()}
    return result


def _profiler(torch, callers: int):
    """The device trace, and the host's ranges of every caller's thread."""
    extra = {}
    if callers > 1:
        extra["experimental_config"] = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA], **extra)


def _quartiles(values: list) -> list:
    import statistics

    return statistics.quantiles(values, n=4) if len(values) > 1 else [values[0]] * 3


def _rates(preset: str) -> tuple[int, int]:
    return {"P444": (1, 1), "P422": (2, 1), "P420": (2, 2)}[preset]


def _scan_bits(jpeg: bytes) -> int:
    """Bits of a JPEG's entropy-coded scan, unstuffed, to the byte: from the
    end of the SOS segment to EOI, each 0xFF 0x00 counted as 0xFF."""
    sos = jpeg.rfind(b"\xff\xda")
    start = sos + 2 + int.from_bytes(jpeg[sos + 2: sos + 4], "big")
    scan = jpeg[start:-2]
    return 8 * (len(scan) - scan.count(b"\xff\x00"))


def _device(torch, device: str, run: Run, traced) -> dict:
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
           "memory_peak_bytes": run.memory_peak_bytes}
    if traced is not None:
        from perfbench.trace import busy_us

        out["busy_s"] = busy_us(traced.kernels + traced.copies, traced.start, traced.end) / 1e6
        out["window_s"] = traced.window_s
    return out


def main(argv: list[str], t0: float, program_hook=None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true",
                    help="run on the CPU at a tiny frame size (tests only; no device numbers)")
    args = ap.parse_args(argv)
    try:
        cell = Cell.load(args.workload)
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace), t0, args.rehearse,
                          program_hook)
    except NoCard as exc:
        log(f"no result: {exc}")
        return 2
    found = banned_modules()  # after the window, the judging and the readers
    if found:
        log(f"no result: loaded in the run's process: {', '.join(found)}")
        return 2
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0
