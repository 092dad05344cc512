"""GPU smoke run of the PyTorch/CUDA port (dmmt_jpeg_encoder_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card, nvcc (CUDA_HOME, PATH or /usr/local/cuda) and this
checkout; imports nothing of JAX. Phases, each failing loudly:

1. the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from csrc/*.cu (nvcc, sm_90a, one process per
   source, all started together);
3. kernel vs plain: on every fixture of tests/torch_port_fixtures.py, each
   kernel (phase 1, histograms, scan pack) against its plain torch version
   on the card, exactly (all outputs are integers); phase 1 on the 4K frame
   also against the plain version on the CPU; kernel and plain times at 4K
   (CUDA events, median of 10 warm runs); the slab scan pack on the small
   odd batch and on the 1080p x 16 group, against its plain version and
   against one scan-pack call per image, exactly, and the times of all
   three on the 1080p group;
4. end to end, each path driven with the launch counts reset just before
   and read just after: every single-image fixture through
   encode_array(device="cuda"); every batch fixture through
   encode_batch(device="cuda") under three arms (the slab with one
   scan-pack call per image, the slab with one slab scan-pack call per
   group, DMMT_SLAB=0); each JPEG's sha256 held against the JAX package's
   CPU goldens (tests/torch_port_goldens.json); each path's kernels must
   have launched, the slab once in phase 1 per group; batch throughput of
   each arm beside an encode_array loop; the 4K frame also through the
   CLI; warm 4K encode time.

The last three lines are the nvidia-smi line, a JSON object with one entry
per kernel, and {"ok": true, "device": {...}}. Exits nonzero, printing no
result, when no CUDA device is available.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
KERNEL_INFO = {
    "phase1": ("dmmt_jpeg_encoder_tpu_torch/csrc/phase1.cu",
               "dmmt_jpeg_encoder_tpu/ops/fused_arai.py:218"),
    "block_hist": ("dmmt_jpeg_encoder_tpu_torch/csrc/block_hist.cu",
                   "dmmt_jpeg_encoder_tpu/ops/pallas_block_hist.py:138"),
    "scan_pack": ("dmmt_jpeg_encoder_tpu_torch/csrc/scan_pack.cu",
                  "dmmt_jpeg_encoder_tpu/bitstream/fused_pack.py:943"),
    "scan_pack_slab": ("dmmt_jpeg_encoder_tpu_torch/csrc/scan_pack.cu",
                       "dmmt_jpeg_encoder_tpu/bitstream/fused_pack.py:1061"),
}
# Published H100 SXM peaks at a 700 W limit: HBM bytes/s, and float32 (and
# 32-bit integer) operations/s outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
# Operations per unit of work, counted from the kernels' arithmetic (an fma
# counts as two): phase 1 per pixel (color 20, P420 subsample 4, Arai row +
# column passes with divide and round 11.5 per coefficient x 1.5
# coefficients per pixel); histograms and scan pack per coefficient.
OPS_PHASE1_PER_PIXEL = 41
OPS_HIST_PER_COEFF = 10
OPS_PACK_PER_COEFF = 30


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = 10) -> float:
    """Median device time of fn() in ms over `reps` warm runs."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wall_ms(fn, reps: int = 3) -> float:
    """Median host wall time of fn() in ms over `reps` runs after two warm
    runs, which also fill encode_batch's staging ring (fn returns host
    results, so each run ends synchronized)."""
    fn()
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def max_abs_err(torch, a, b) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()) if a.numel() else 0


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(least time in ms, what bounds it) for work that must move n_bytes
    and do n_ops."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, n_ops / PEAK_OPS_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def pack_bytes(n_blocks: int, n_images: int, total_bits) -> int:
    """Bytes a scan pack must move: each block read once, each image's four
    tables read once, the stream's words and the bit count written once."""
    words = sum((int(b) + 31) // 32 for b in total_bits)
    return n_blocks * 128 + n_images * (2 * 4 * 256 * 4 + 8) + words * 4


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(REPO), str(REPO / "tests")]
    import dmmt_jpeg_encoder_tpu_torch as port
    from dmmt_jpeg_encoder_tpu_torch.bitstream.device_pack import (
        interleave_scan,
        pack_scan_plain,
        pack_scan_slab_plain,
    )
    from dmmt_jpeg_encoder_tpu_torch.bitstream.fused_pack import (
        fused_pack_words,
        fused_pack_words_slab,
    )
    from dmmt_jpeg_encoder_tpu_torch.encoder import slab_depth
    from dmmt_jpeg_encoder_tpu_torch.entropy.categorize import symbol_histograms
    from dmmt_jpeg_encoder_tpu_torch.huffman.device_tables import (
        device_code_tables_batched,
        pad_dc_histogram,
    )
    from dmmt_jpeg_encoder_tpu_torch.io.ppm import write_ppm
    from dmmt_jpeg_encoder_tpu_torch.kernels import build
    from dmmt_jpeg_encoder_tpu_torch.onedispatch import pack_inputs
    from dmmt_jpeg_encoder_tpu_torch.ops.block_hist import fused_block_histograms
    from dmmt_jpeg_encoder_tpu_torch.ops.fused_arai import fused_arai_phase1
    from dmmt_jpeg_encoder_tpu_torch.ops.geometry import padded_size
    from dmmt_jpeg_encoder_tpu_torch.pipeline import dc_dpcm, phase1_zigzag_blocks
    from dmmt_jpeg_encoder_tpu_torch.tables import quantization_table_pair
    from dmmt_jpeg_encoder_tpu_torch.utils.native import load_native
    from torch_port_fixtures import (
        BATCH_FIXTURES,
        FIXTURES,
        batch_frames,
        fixture_pixels,
        load_batch_goldens,
        load_goldens,
        sha256,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gpu = gpu_line()
    log(f"gpu: {gpu}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # --- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    build.load()
    log(f"build: {time.perf_counter() - t0:.1f} s -> {build.library_path().name}")

    goldens = load_goldens()
    images = {}
    for name, f in FIXTURES.items():
        px = fixture_pixels(name)
        if sha256(px) != goldens[name]["pixels_sha256"]:
            raise AssertionError(f"{name}: fixture pixels differ from the goldens' (numpy {np.__version__})")
        images[name] = px
    batch_goldens = load_batch_goldens()
    batches = {}
    for name in BATCH_FIXTURES:
        batches[name] = batch_frames(name)
        if [sha256(px) for px in batches[name]] != [g["pixels_sha256"]
                                                     for g in batch_goldens[name]]:
            raise AssertionError(f"{name}: batch pixels differ from the goldens' "
                                 f"(numpy {np.__version__})")

    def config_of(f):
        return port.EncoderConfig(chroma_subsampling=port.ChromaSubsamplingPreset(f["preset"]),
                                  quality=f["quality"])

    # --- 3. kernel vs plain ------------------------------------------------
    errs = {k: 0 for k in KERNEL_INFO}
    timing, bounds = {}, {}
    for name, f in FIXTURES.items():
        preset = port.ChromaSubsamplingPreset(f["preset"])
        lq, cq = (torch.from_numpy(t).to(dev) for t in quantization_table_pair(
            port.QuantizationTablePreset.SPECIFICATION, f["quality"]))
        rgb = torch.from_numpy(images[name]).to(dev)
        maxval = f["maxval"]

        def k1():
            return fused_arai_phase1(rgb, maxval, lq, cq, preset)

        def p1():
            return phase1_zigzag_blocks(rgb, maxval, lq, cq, preset)

        kern, plain = k1(), p1()
        for a, b in zip(kern, plain):
            if not torch.equal(a, b):
                raise AssertionError(f"{name}: phase1 kernel != plain ({(a != b).sum().item()} values)")
            errs["phase1"] = max(errs["phase1"], max_abs_err(torch, a, b))
        blocks = [dc_dpcm(b) for b in kern]
        chroma = torch.cat(blocks[1:])

        def k2():
            return fused_block_histograms(blocks[0]), fused_block_histograms(chroma)

        def p2():
            return symbol_histograms(blocks[0]), symbol_histograms(chroma)

        hk, hp = k2(), p2()
        for a, b in zip([*hk[0], *hk[1]], [*hp[0], *hp[1]]):
            if not torch.equal(a, b):
                raise AssertionError(f"{name}: block_hist kernel != plain")
            errs["block_hist"] = max(errs["block_hist"], max_abs_err(torch, a, b))
        tables = device_code_tables_batched(torch.stack([
            pad_dc_histogram(hk[0][0]), hk[0][1], pad_dc_histogram(hk[1][0]), hk[1][1]]))
        lpm = preset.luma_blocks_per_mcu
        scan = interleave_scan(blocks[0], blocks[1], blocks[2], int(blocks[1].shape[0]), lpm)
        n_words = int(scan.shape[0]) * 64 + 2
        args = (scan, lpm + 2, lpm, tables["codes_flat"], tables["lens_flat"], n_words)

        def k3():
            return fused_pack_words(*args)

        def p3():
            return pack_scan_plain(*args)

        wk, wp = k3(), p3()
        for a, b in zip(wk, wp):
            if not torch.equal(a, b):
                raise AssertionError(f"{name}: scan_pack kernel != plain")
            errs["scan_pack"] = max(errs["scan_pack"], max_abs_err(torch, a, b))
        log(f"{name}: kernels == plain (blocks {int(scan.shape[0])}, bits {int(wk[1].item())})")

        if name == "4k_p420":
            cpu = phase1_zigzag_blocks(rgb.cpu(), maxval, lq.cpu(), cq.cpu(), preset)
            for a, b in zip(kern, cpu):
                if not torch.equal(a.cpu(), b):
                    raise AssertionError("4k_p420: phase1 kernel != plain on the CPU")
            log("4k_p420: phase1 kernel == plain on the CPU")
            for kname, kf, pf in (("phase1", k1, p1), ("block_hist", k2, p2), ("scan_pack", k3, p3)):
                timing[kname] = (cuda_ms(torch, kf), cuda_ms(torch, pf))
                log(f"4k {kname}: kernel {timing[kname][0]:.4f} ms, plain {timing[kname][1]:.4f} ms")
            n_blocks, n_px = int(scan.shape[0]), rgb.numel() // 3
            coeff_bytes = n_blocks * 128
            bounds["phase1"] = bound(rgb.numel() * rgb.element_size() + coeff_bytes + 2 * 64 * 4,
                                     n_px * OPS_PHASE1_PER_PIXEL)
            bounds["block_hist"] = bound(coeff_bytes + 2 * 272 * 4,
                                         n_blocks * 64 * OPS_HIST_PER_COEFF)
            bounds["scan_pack"] = bound(pack_bytes(n_blocks, 1, wk[1].tolist()),
                                        n_blocks * 64 * OPS_PACK_PER_COEFF)

    # the slab scan pack: against its plain version and one scan-pack call per image
    for name in ("batch_odd_p422", "batch_1080p_p420"):
        f = BATCH_FIXTURES[name]
        preset = port.ChromaSubsamplingPreset(f["preset"])
        lq, cq = (torch.from_numpy(t).to(dev) for t in quantization_table_pair(
            port.QuantizationTablePreset.SPECIFICATION, f["quality"]))
        b = f["n"]
        ph, pw = padded_size(f["height"], f["width"], preset)
        stack = np.zeros((b, ph, pw, 3), np.uint8)
        stack[:, : f["height"], : f["width"]] = np.stack(batches[name])
        rgb = torch.from_numpy(stack).to(dev).reshape(b * ph, pw, 3)
        scans, tables, _ = pack_inputs(rgb, b, f["maxval"], preset, lq, cq)
        lpm = preset.luma_blocks_per_mcu
        n_words = int(scans.shape[1]) * 64 + 2
        codes = tables["codes_flat"].reshape(b, 4, 256)
        lens = tables["lens_flat"].reshape(b, 4, 256)

        def k4():
            return fused_pack_words_slab(scans, lpm + 2, lpm, codes, lens, n_words)

        def p4():
            return pack_scan_slab_plain(scans, lpm + 2, lpm, codes, lens, n_words)

        def k3_each():
            return [fused_pack_words(scans[i], lpm + 2, lpm, codes[i], lens[i], n_words)
                    for i in range(b)]

        wk, wp, singles = k4(), p4(), k3_each()
        each = (torch.stack([w for w, _ in singles]), torch.cat([t for _, t in singles]))
        for ref, what in ((wp, "plain"), (each, f"{b} scan_pack calls")):
            for x, y in zip(wk, ref):
                if not torch.equal(x, y):
                    raise AssertionError(f"{name}: scan_pack_slab kernel != {what}")
                errs["scan_pack_slab"] = max(errs["scan_pack_slab"], max_abs_err(torch, x, y))
        log(f"{name}: scan_pack_slab == plain == {b} scan_pack calls "
            f"({b} x {int(scans.shape[1])} blocks, bits {wk[1].tolist()})")
        if name == "batch_1080p_p420":
            t_k4, t_plain, t_each = cuda_ms(torch, k4), cuda_ms(torch, p4), cuda_ms(torch, k3_each)
            timing["scan_pack_slab"] = (t_k4, t_plain)
            n_blocks = b * int(scans.shape[1])
            bounds["scan_pack_slab"] = bound(pack_bytes(n_blocks, b, wk[1].tolist()),
                                             n_blocks * 64 * OPS_PACK_PER_COEFF)
            log(f"1080p x {b} scan_pack_slab: kernel {t_k4:.4f} ms, {b} scan_pack calls "
                f"{t_each:.4f} ms, plain {t_plain:.4f} ms, "
                f"bound {bounds['scan_pack_slab'][0]:.4f} ms")

    # --- 4. end to end -----------------------------------------------------
    launches = {k: 0 for k in KERNEL_INFO}

    def run_path(label, fn, expect):
        """Drive one path with the counts reset just before and read just
        after; `expect` maps kernel -> required count (None: at least one)."""
        build.reset_launch_counts()
        result = fn()
        counts = build.launch_counts()
        log(f"{label} launches: {counts}")
        for k, want in expect.items():
            if (counts[k] == 0) if want is None else (counts[k] != want):
                raise AssertionError(f"{label}: {k} launched {counts[k]} times, expected "
                                     f"{'at least one' if want is None else want}")
        for k, n in counts.items():
            launches[k] += n
        return result

    configs = {name: config_of(f) for name, f in FIXTURES.items()}
    outputs = run_path("single-image fixtures", lambda: {
        name: port.encode_array(images[name], f["maxval"], configs[name], device=dev)
        for name, f in FIXTURES.items()
    }, {"phase1": None, "block_hist": None, "scan_pack": None, "scan_pack_slab": 0})
    for name, jpeg in outputs.items():
        if sha256(jpeg) != goldens[name]["jpeg_sha256"] or len(jpeg) != goldens[name]["jpeg_len"]:
            raise AssertionError(f"{name}: cuda JPEG differs from the JAX golden ({len(jpeg)} bytes)")
        log(f"{name}: cuda bytes == JAX golden ({len(jpeg)} bytes)")

    arms = {"slab": {"DMMT_SLAB_ONEPACK": "0"}, "slab_onepack": {"DMMT_SLAB_ONEPACK": "1"},
            "per_image": {"DMMT_SLAB": "0"}}
    for name in ("batch_1080p_p420", "batch_4k_p420"):
        f, frames = BATCH_FIXTURES[name], batches[name]
        cfg = config_of(f)
        mpix = f["n"] * f["height"] * f["width"] / 1e6
        want = [g["jpeg_sha256"] for g in batch_goldens[name]]
        rates = {}
        for arm, env in arms.items():
            saved = {k: os.environ.get(k) for k in ("DMMT_SLAB", "DMMT_SLAB_ONEPACK")}
            os.environ.update(env)
            try:
                depth = slab_depth(frames, cfg)
                groups = -(-f["n"] // depth)
                if (depth > 1) != (arm != "per_image"):
                    raise AssertionError(f"{name} {arm}: the gate chose depth {depth}")
                expect = {"phase1": groups if depth > 1 else f["n"], "block_hist": 2 * f["n"],
                          "scan_pack": 0 if arm == "slab_onepack" else f["n"],
                          "scan_pack_slab": groups if arm == "slab_onepack" else 0}

                def batch():
                    return port.encode_batch(frames, f["maxval"], cfg, device=dev)

                out = run_path(f"{name} {arm} (depth {depth})", batch, expect)
                if [sha256(j) for j in out] != want:
                    raise AssertionError(f"{name} {arm}: cuda JPEGs differ from the JAX goldens")
                rates[arm] = mpix / wall_ms(batch) * 1e3
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
        rates["encode_array_loop"] = mpix / wall_ms(lambda: [
            port.encode_array(px, f["maxval"], cfg, device=dev) for px in frames]) * 1e3
        log(f"{name}: every frame == JAX golden under all three arms; throughput Mpix/s "
            + ", ".join(f"{k} {v:.1f}" for k, v in rates.items()) + f" on {gpu}")

    if load_native() is None:
        raise AssertionError("native PPM parser did not build (cc); the 4K CLI run needs it")
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = Path(tmp) / "in.ppm", Path(tmp) / "out.jpg"
        write_ppm(src, images["4k_p420"], 255)
        t0 = time.perf_counter()
        subprocess.run(
            [sys.executable, "-m", "dmmt_jpeg_encoder_tpu_torch", str(src), str(dst), "-p", "P420"],
            cwd=REPO, check=True, timeout=600,
        )
        cli_s = time.perf_counter() - t0
        if sha256(dst.read_bytes()) != goldens["4k_p420"]["jpeg_sha256"]:
            raise AssertionError("4K CLI output differs from the JAX golden")
    log(f"4k CLI (process start, PPM parse, build load, encode): {cli_s:.2f} s, bytes == JAX golden")

    f4k = FIXTURES["4k_p420"]
    times = []
    for _ in range(11):
        t0 = time.perf_counter()
        port.encode_array(images["4k_p420"], 255, configs["4k_p420"], device=dev)
        times.append((time.perf_counter() - t0) * 1e3)
    e2e_ms = statistics.median(times[1:])
    mpix = f4k["height"] * f4k["width"] / 1e6
    log(f"4k e2e encode_array (host array in, JPEG bytes out): median {e2e_ms:.3f} ms, "
        f"{mpix / e2e_ms * 1e3:.1f} Mpix/s on {gpu}")

    kernels = [
        {"name": k, "route": "cuda", "source": source, "replaces": rep, "launches": launches[k],
         "max_abs_err": errs[k], "ms": timing[k][0], "plain_ms": timing[k][1],
         "bound_ms": bounds[k][0], "bound_by": bounds[k][1], "library_ms": None}
        for k, (source, rep) in KERNEL_INFO.items()
    ]
    print(gpu)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
