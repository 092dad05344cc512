"""encode_batch on a CUDA card: the slab-depth sweep and a profiler trace.

    python -m dmmt_jpeg_encoder_tpu_torch.tools.batch_sweep sweep
    python -m dmmt_jpeg_encoder_tpu_torch.tools.batch_sweep trace
    python -m dmmt_jpeg_encoder_tpu_torch.tools.batch_sweep stages
    python -m dmmt_jpeg_encoder_tpu_torch.tools.batch_sweep single OTHER_CHECKOUT

`sweep` times encode_batch (host arrays in, JPEG bytes out, warm, median
of 3) on 32 distinct P420 frames 3840 wide, at 272, 544, 1088 and 2160
rows, for slab depths B in {1, 2, 4, 8, 16, 32} (B = 1 is the pipelined
per-image path, DMMT_SLAB=0) and both slab pack arms, and prints one JSON
line per cell with the time per image. The group bound is lifted for the
sweep (DMMT_SLAB_MAX_BLOCKS).

`trace` runs encode_batch under torch.profiler on 16 1080p frames (slab)
and on 4 2160p frames (per-image path), writes each Chrome trace under
build/traces/, and prints per run: host wall time, device busy time and
idle share, and how much of the host->device and device->host copy time
overlaps kernel time.

`stages` times the host side of the same runs (and of the slab's one-pack
arm) with a host clock around each step of encode_batch: staging and
upload issue, enqueue of the device work, the small-copy enqueue, the wait
for it, the table-spec decode, the word fetch, byte stuffing and the
container; it prints ms per image for each.

`single OTHER_CHECKOUT` compares the single-image encode_array of this
checkout with another one (for example the parent commit, unpacked with
git archive) on one card: each side in its own process, three rounds in
the order other, this, this, other, median of 20 warm 3840x2160 P420
encodes each. Each process also reports the host cost of one small CUDA
allocation (µs), a probe of how fast the shared host ran just then.

Both need a card and fail without one.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .. import encoder
from ..config import EncoderConfig

WIDTH = 3840
ROWS = (272, 544, 1088, 2160)
DEPTHS = (1, 2, 4, 8, 16, 32)
N_FRAMES = 32
OUT = Path(__file__).resolve().parents[2] / "build" / "traces"


def frames(n: int, rows: int, width: int, seed: int) -> list[np.ndarray]:
    """n distinct uint8 RGB frames: a ramp, tiles and a sawtooth, shifted
    per frame, plus per-frame noise (integer numpy only)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:rows, 0:width].astype(np.int32)
    out = []
    for i in range(n):
        x = xx + 37 * i
        base = 40 + (x * 150) // (width + 37 * n) + (yy * 50) // rows
        base += ((x // 53 + yy // 31) % 3) * 12 + ((x * 7 + yy * 3) % 64 - 32) // 4
        rgb = base[..., None] + np.array([0, -10, 12], np.int32)
        rgb += rng.integers(-8, 9, size=(rows, width, 3), dtype=np.int32)
        out.append(np.clip(rgb, 0, 255).astype(np.uint8))
    return out


KNOBS = ("DMMT_SLAB", "DMMT_SLAB_B", "DMMT_SLAB_ONEPACK", "DMMT_SLAB_MAX_ROWS",
         "DMMT_SLAB_MAX_BLOCKS", "DMMT_UPLOAD_DEPTH")


def _set_env(**kv) -> None:
    """Set the given knobs and reset every other one to its default."""
    for k in KNOBS:
        os.environ.pop(k, None)
    os.environ.update({k: str(v) for k, v in kv.items()})


def _timed_batch(imgs: list[np.ndarray], config: EncoderConfig, reps: int = 3) -> float:
    """Median wall ms of encode_batch over `reps` warm runs (two warm-up
    runs fill the staging ring)."""
    for _ in range(2):
        encoder.encode_batch(imgs, 255, config, device="cuda")
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        encoder.encode_batch(imgs, 255, config, device="cuda")
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def sweep() -> None:
    config = EncoderConfig()
    for rows in ROWS:
        imgs = frames(N_FRAMES, rows, WIDTH, seed=rows)
        for b in DEPTHS:
            arms = ([("pipelined", "0", "0")] if b == 1
                    else [("slab", "1", "0"), ("slab_onepack", "1", "1")])
            for arm, slab, onepack in arms:
                _set_env(DMMT_SLAB=slab, DMMT_SLAB_ONEPACK=onepack, DMMT_SLAB_B=b,
                         DMMT_SLAB_MAX_BLOCKS=1 << 40)
                ms = _timed_batch(imgs, config)
                encoder._STAGING.clear()
                print(json.dumps({"rows": rows, "width": WIDTH, "B": b, "arm": arm,
                                  "ms_per_image": ms / N_FRAMES,
                                  "mpix_per_s": rows * WIDTH * N_FRAMES / ms / 1e3}), flush=True)


def _union(iv: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _length(iv: list[tuple[float, float]]) -> float:
    return sum(b - a for a, b in iv)


def _overlap(x: list[tuple[float, float]], y: list[tuple[float, float]]) -> float:
    """Length of the intersection of two disjoint sorted interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(x) and j < len(y):
        lo, hi = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        total += max(0.0, hi - lo)
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return total


def trace_summary(trace_file: Path, wall_ms: float) -> dict:
    """Device busy time, idle share and copy/kernel overlap from a Chrome
    trace written by torch.profiler (times in µs)."""
    events = json.loads(trace_file.read_text())["traceEvents"]
    spans: dict[str, list] = {"kernel": [], "htod": [], "dtoh": [], "other": []}
    for e in events:
        cat, name = e.get("cat", ""), e.get("name", "")
        if cat not in ("kernel", "gpu_memcpy", "gpu_memset") or "dur" not in e:
            continue
        kind = "kernel" if cat == "kernel" else "htod" if "HtoD" in name else \
            "dtoh" if "DtoH" in name else "other"
        spans[kind].append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    u = {k: _union(v) for k, v in spans.items()}
    busy = _union(sum(spans.values(), []))
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": _length(busy) / 1e3,
        "idle_share": 1 - _length(busy) / 1e3 / wall_ms,
        "kernel_ms": _length(u["kernel"]) / 1e3,
        "htod_ms": _length(u["htod"]) / 1e3,
        "htod_overlapping_kernels_ms": _overlap(u["htod"], u["kernel"]) / 1e3,
        "dtoh_ms": _length(u["dtoh"]) / 1e3,
        "dtoh_overlapping_kernels_ms": _overlap(u["dtoh"], u["kernel"]) / 1e3,
        "n_kernels": len(spans["kernel"]),
    }


def trace() -> None:
    from torch.profiler import ProfilerActivity, profile

    OUT.mkdir(parents=True, exist_ok=True)
    config = EncoderConfig()
    runs = {
        "slab_1080p_x16": (frames(16, 1080, 1920, seed=1), {}),
        "pipelined_2160p_x4": (frames(4, 2160, 3840, seed=2), {"DMMT_SLAB": "0"}),
    }
    for name, (imgs, env) in runs.items():
        _set_env(**env)
        for _ in range(2):  # warm, and fill the staging ring
            encoder.encode_batch(imgs, 255, config, device="cuda")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            encoder.encode_batch(imgs, 255, config, device="cuda")
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        path = OUT / f"trace_{name}.json"
        prof.export_chrome_trace(str(path))
        print(json.dumps({"run": name, **trace_summary(path, wall_ms)}), flush=True)


def stages() -> None:
    from .. import onedispatch

    config = EncoderConfig()
    totals: dict[str, float] = {}
    targets = [
        (encoder, "_upload", "stage + upload issue"),
        (encoder, "start_one_dispatch_slab", "enqueue"),
        (encoder, "start_one_dispatch", "enqueue"),
        (encoder, "prefetch_one_dispatch", "small-copy enqueue"),
        (encoder, "finish_one_dispatch", "finish"),
        (onedispatch, "tables_from_spec", "spec decode"),
        (onedispatch, "_fetch_words", "word fetch"),
        (onedispatch, "finalize_scan_bytes", "stuffing"),
        (encoder, "_jpeg", "container"),
    ]
    originals = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in targets]

    def timed(fn, label):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                totals[label] = totals.get(label, 0.0) + (time.perf_counter() - t0) * 1e3
        return wrapper

    runs = {
        "slab_1080p_x16": (frames(16, 1080, 1920, seed=1), {}),
        "slab_onepack_1080p_x16": (frames(16, 1080, 1920, seed=1), {"DMMT_SLAB_ONEPACK": "1"}),
        "slab_2160p_x4": (frames(4, 2160, 3840, seed=2), {}),
        "pipelined_2160p_x4": (frames(4, 2160, 3840, seed=2), {"DMMT_SLAB": "0"}),
    }
    try:
        for mod, attr, label in targets:
            setattr(mod, attr, timed(getattr(mod, attr), label))
        for name, (imgs, env) in runs.items():
            _set_env(**env)
            for _ in range(2):  # warm, and fill the staging ring
                encoder.encode_batch(imgs, 255, config, device="cuda")
            torch.cuda.synchronize()
            totals.clear()
            t0 = time.perf_counter()
            encoder.encode_batch(imgs, 255, config, device="cuda")
            wall = (time.perf_counter() - t0) * 1e3
            inner = sum(totals[k] for k in ("spec decode", "word fetch", "stuffing"))
            per = {k: v / len(imgs) for k, v in totals.items()}
            per["finish"] = (totals["finish"] - inner) / len(imgs)
            per = {("wait for small copy" if k == "finish" else k): v for k, v in per.items()}
            per["other"] = wall / len(imgs) - sum(per.values())
            print(json.dumps({"run": name, "wall_ms_per_image": wall / len(imgs), **per}),
                  flush=True)
    finally:
        for mod, attr, fn in originals:
            setattr(mod, attr, fn)


_SINGLE = """
import statistics, sys, time
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
import dmmt_jpeg_encoder_tpu_torch as port
rng = np.random.default_rng(0)
yy, xx = np.mgrid[0:2160, 0:3840].astype(np.int32)
base = 40 + (xx * 150) // 3840 + (yy * 50) // 2160 + ((xx // 53 + yy // 31) % 3) * 12
px = np.clip(base[..., None] + rng.integers(-8, 9, (2160, 3840, 3)), 0, 255).astype(np.uint8)
times = []
for _ in range(21):
    t0 = time.perf_counter()
    port.encode_array(px, 255, device="cuda")
    times.append((time.perf_counter() - t0) * 1e3)
t0 = time.perf_counter()
for _ in range(2000):
    torch.empty(16, device="cuda")
print(statistics.median(times[1:]), (time.perf_counter() - t0) / 2000 * 1e6)
"""


def single(other: str) -> None:
    import subprocess

    this = str(Path(__file__).resolve().parents[2])
    for label, root in (("other", other), ("this", this), ("this", this), ("other", other)) * 3:
        out = subprocess.run([sys.executable, "-c", _SINGLE, str(Path(root).resolve())],
                             capture_output=True, text=True, check=True, cwd=root)
        ms, alloc_us = (float(x) for x in out.stdout.split()[-2:])
        print(json.dumps({"run": "encode_array_2160p", "checkout": label, "median_ms": ms,
                          "host_alloc_us": alloc_us}), flush=True)


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("batch_sweep: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if argv[:1] == ["single"]:
        single(argv[1])
        return 0
    modes = {"sweep": sweep, "trace": trace, "stages": stages}
    for mode in argv or list(modes):
        modes[mode]()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
