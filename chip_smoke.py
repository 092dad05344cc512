"""GPU smoke run of the PyTorch/CUDA port (dmmt_jpeg_encoder_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card, nvcc (CUDA_HOME, PATH or /usr/local/cuda) and this
checkout; imports nothing of JAX. Phases, each failing loudly:

1. the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from csrc/*.cu (nvcc, sm_90a, one process per
   source, all started together);
3. kernel vs plain: on every fixture of tests/torch_port_fixtures.py, each
   kernel (phase 1, block histograms, scan pack; the weighted histogram on
   the four DMMT_HIST=pallas counts, the table lookup on the staged pack's
   two lookups, the emission pack on the staged pack's emissions) against
   its plain torch version on the card, exactly (all outputs are
   integers); phase 1 on the 4K frame also against the plain version on
   the CPU; kernel, plain and (where one PyTorch call computes the same
   function) library times at 4K (the card's time per call: R
   back-to-back calls between two CUDA events behind a spin kernel that
   outlasts their enqueue, divided by R, the window at least 2 ms, median
   of 5 windows; tools/timing.py);
   the slab scan pack on the small odd batch and on the 1080p x 16 group,
   against its plain version and against one scan-pack call per image,
   exactly, and the times of all three on the 1080p group; the grouped
   histogram, grouped lookup and emission pack with per-image word-aligned
   stream bases on the 1080p x 16 fused batch, against their plain
   versions, exactly, with their times; on every fixture, the four kernels
   of the phase-1 routes (the plane DCT of DMMT_P1=pallas, the matmul
   plane DCT of DMMT_P1=mxu and the SIMPLE and SEPARATED variants, the
   fused matmul phase 1 of DMMT_P1=fused1, the block DCT of the FUSED
   variant; the two matmul kernels also in their split arms, which
   DMMT_P1_PREC=high takes) on the inputs those routes give them, against
   their plain versions, exactly, with kernel, plain and library times at 4K, and the
   color planes those routes make in plain torch against the same on the
   CPU; the scan pack with the sharded encode's `valid` mask (a prefix,
   and no block) on every fixture and the slab scan pack with a [B, N]
   mask (per-image prefixes, and none) on both batch groups, against
   their plain versions and (slab) one masked scan-pack call per image,
   exactly, with kernel, plain and mask-free times at 4K and 1080p x 16;
   the capability probe (x + 1 on [8, 128] float32) against x + 1; the
   block DCT and the lookup on the edge shapes of their tilings
   (tests/torch_port_fixtures.py: N of 1, a tile less one, a tile, a tile
   and one, three tiles and five; G, m, T around the lookup's int4
   vectors, with symbols -1, T and T + 1), each also from a view 4 bytes
   past a 16-byte boundary, against their plain versions, exactly; the
   same for the scan pack (N of 1 and around its 128-block tile, blocks
   with no AC, all 63 AC, zero runs of 15-48, only position 63, DC and AC
   of the largest categories, tiles past its shared word buffer beside
   tiles within it; `valid` all, none, alternating and single; the slab
   form at B = 1 and 3, also against one scan-pack call per image, tables
   built from each case's histograms), for the block histograms (N from 1
   to 389 with the prefixes 0, 1, N - 1 and N, the scan pack's coding
   corners, chroma calls of two segments of unequal and odd lengths) and
   for phase 1 and the fused matmul phase 1, both arms (1x1 to 333x1001,
   rows that are no whole 16-byte chunks, each preset, 16-bit samples,
   maxval 1), for the matmul plane DCT, both arms (widths of 1 to 241 groups, one and three
   group rows, stacked chroma; saturated groups, DCs on x.5 after / q, a
   table past 8 bits), with its division by 8-bit table entries held
   against __fdiv_rn over every finite float32, and for the emission pack
   (N of 1 and around its 32-block tile,
   2040-bit blocks past its shared word window beside tiles within it,
   masked blocks and a tile of them, two and three images at word-aligned
   bases, a word buffer that drops the stream's second half), for the
   weighted histogram (M of 0-5 and odd, G of 1, 3 and 16 with unaligned
   rows, 1, 16 and 256 bins, symbols out of range, weights 0, 1, larger
   and negative, a bin past 2^24, rows of many CTAs; also with only the
   symbols unaligned, its arm for symbols and weights aligned unalike;
   and twice in turn with the block histograms between, which share its
   ticket state, on one stream, then on a second) and for the Arai plane
   DCT (the matmul plane
   DCT's shapes and inputs, 8-bit tables also as uint8);
4. end to end, each path driven with the launch counts reset just before
   and read just after: every single-image fixture through
   encode_array(device="cuda"), one-dispatch and two-dispatch
   (one_dispatch="off"); the 4K frame two-dispatch with the staged pack
   (DMMT_NO_FUSED_PACK=1), with DMMT_HIST=pallas, and with the host scan
   backend; every batch fixture through encode_batch(device="cuda") under
   three arms (the slab with one scan-pack call per image, the slab with
   one slab scan-pack call per group, DMMT_SLAB=0) and the two large ones
   also with fused_batch (16 and 4); each JPEG's sha256 held against the
   JAX package's CPU goldens (tests/torch_port_goldens.json); each path's
   kernels must have launched as often as the path launches them; batch
   throughput of each arm beside an encode_array loop; the 4K frame also
   through the CLI, one-dispatch and --one-dispatch off; then every
   phase-1 route (DMMT_P1=pallas, mxu, fused1; the SIMPLE, SEPARATED and
   FUSED variants; mxu and fused1 under DMMT_P1_PREC=high) on every
   single-image fixture, one-dispatch and two-dispatch, and the 16 x 1080p batch as slab and fused_batch=16 under
   DMMT_P1=mxu and FUSED, each held against the route's goldens with the
   route's kernels counted; SIMPLE under DMMT_P1_PREC=high, which it does
   not read (its goldens, its unsplit kernel); warm 4K encode time, one-dispatch and
   two-dispatch, and one-dispatch under each route;
   then channel-planar input: the 4K frame and the 7x17 fixture as
   [3, H, W] (a host array, and a tensor on the card) through
   start_one_dispatch on the default route and under DMMT_P1=fused1 (also
   with DMMT_P1_PREC=high), the
   odd batch and the 16 x 1080p batch as planar [B, 3, H, W] host stacks
   through start_one_dispatch_slab; start_one_dispatch_multi on 4 x 1080p
   (interleaved and planar host stacks), every state finished in the JAX
   package's call form (state, config); each JPEG held against its golden
   with its launches counted; the multi start + finishes timed against a
   loop of single starts + finishes, in 10 alternating rounds; the 4K
   golden JPEG decoded by the port's debug.jpeg_decoder (the card's machine
   has no PIL), its PSNR against the source held to the floor that
   tests/test_torch_tooling.py measures on the CPU;
   then the one-dispatch programs (CUDA graphs, onedispatch.py on
   programs.py): every
   fixture under every route, the 333x1001 fixture under DMMT_HIST=matmul
   and pallas, the 4K and 7x17 frames as planar host arrays and card
   tensors, the odd and 1080p batches through start_one_dispatch_slab with
   DMMT_SLAB_ONEPACK=0 and 1, and 4 x 1080p through
   start_one_dispatch_multi (interleaved and planar): each replayed JPEG
   held against the eager enqueue's (onedispatch._enqueue, op by op) and
   its golden, each call exactly one graph replay with the per-image
   kernel counts; 8 starts on 8 rolled 4K frames in flight, finished in
   reverse order, each against its frame's two-dispatch bytes; DMMT_P1
   toggled to fused1 after the first capture at 4K and back (the
   p1_fused1 golden, then the default's); then, eager enqueue against
   graph replay in 10 alternating rounds, one start's host time, the
   program floor (8 starts in flight, per image) and the 4K e2e; the
   graphs' memory and torch.cuda.memory_reserved() after the phase.
   Every path of phases 4-4c also checks its graph replays (one per
   start, slab or multi call; on the two-dispatch and fused paths one per
   half: the first half's program and the pack's, none for the host scan
   backend's pack);
5. the sharded encode (parallel/sharding.py), its shards on card 0 (a
   device list that repeats it), each path's launches counted with the
   capability probe among them: every single-image fixture at
   num_shards 2 and 8, one-dispatch, one_dispatch="off" (not read on the
   sharded path, as in the JAX package: one dispatch again) and past a
   device table bound lowered to one symbol (the two-dispatch encode with
   the scan-pack kernel, counted); the 4K frame
   at 2 and 4 shards with the staged pack, DMMT_HIST=pallas, the host scan
   backend, DMMT_P1=mxu with DMMT_P1_PREC=high, FUSED (both the default
   bytes, as in the JAX
   package's sharded phase 1) and SIMPLE; the 16 x 1080p batch at 2
   shards as sharded slab, slab one-pack and per image; the CLI with
   --shards 2 (and its refusal of --device cuda on too few cards); the
   same across distinct cards where the machine has them; the
   multi-process encode (parallel/multihost.py) in two gloo processes;
   every JPEG held against the JAX goldens; with its shards on one card
   each sharded one-dispatch start and sharded slab call is exactly one
   replay of a captured program (parallel/sharding.py's
   _compiled_sharded_onedispatch and _compiled_sharded_onedispatch_slab;
   build.REPLAYS "sharded_onedispatch" and "sharded_onedispatch_slab"; the
   two-dispatch encode one replay of _compiled_sharded and, but for the
   host scan backend, one of _compiled_shard_pack) with the kernel counts
   of sharded_launches, and its JPEGs equal the eager enqueue's
   (sharding._start and the op-by-op packs, as across distinct cards); then what
   sharding costs on one card: the warm 4K encode at 1, 2 and 4 shards and
   the 16 x 1080p batch as slab and as sharded slab; two sharded starts in
   flight on two rolled 4K frames, finished in reverse order, each against
   its frame's two-dispatch bytes; DMMT_HIST=pallas toggled after the
   first sharded capture at 4K and back; then, eager enqueue against
   replay in 10 alternating rounds at n = 2 and 4 on one card, one sharded
   start's host time, the program floor (8 starts in flight on pixels
   already on the card, per image), the 4K e2e and the 16 x 1080p sharded
   slab, and the graphs' bytes;
5b. the two-dispatch programs (CUDA graphs: pipeline.py's
   _compiled_pipeline and _compiled_pipeline_batch, bitstream/
   device_pack.py's _compiled_fused_pack, _compiled_pack and
   _compiled_pack_batch, parallel/sharding.py's _compiled_sharded and
   _compiled_shard_pack): every fixture with one_dispatch="off", the 4K
   frame with the fused pack, the staged pack, DMMT_HIST=pallas and the
   host scan backend, 16 x 1080p with fused_batch=16, and the sharded
   two-dispatch at n = 2 on card 0 past a device table bound lowered to
   one symbol and under DMMT_NO_FUSED_PACK=1: each replayed JPEG held
   against the eager enqueue's (programs.card naming no card:
   eager_programs) and its golden, each half one replay with its
   kernels counted; each start function's state (single, slab, multi,
   sharded, sharded slab, sharded two-dispatch) finished, then another
   image started on its instance and finished, then the first finished
   again: its first bytes and tables; pack_scan of one two-dispatch
   result twice with another image's replays between; then, eager
   enqueue against replay in 10 alternating rounds, the host time of each
   half of a 4K two-dispatch encode (fused and staged pack), the 4K e2e
   (both packs), 16 x 1080p fused_batch=16 and the sharded two-dispatch
   at n = 2 on one card (both arms), and each instance's graph bytes;
6. the port's bench stage, `python -m dmmt_jpeg_encoder_tpu_torch.bench
   --rounds 3` in its own process: it must exit 0 (no stage or candidate
   failed, every timed JPEG equal to its reference) with every metric of
   bench.METRIC_ORDER final, in that order; its metric lines are printed,
   and its launch counts (from 0 in that process, read at its end) join
   the kernels' counts; then the projected scaling table of
   parallel/projection.py from its committed H100 points, printed.

A captured program's kernels count as its capture launched them, once per
replay (kernels/build.py); its warm-up and capture count nothing. The last
three lines are the nvidia-smi line, a JSON object with one entry per
kernel, and {"ok": true, "device": {...}}. Exits nonzero, printing no
result, when no CUDA device is available.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import socket
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
    "histogram": ("dmmt_jpeg_encoder_tpu_torch/csrc/histogram.cu",
                  "dmmt_jpeg_encoder_tpu/ops/pallas_histogram.py:123, "
                  "dmmt_jpeg_encoder_tpu/ops/pallas_histogram.py:187"),
    "table_lookup": ("dmmt_jpeg_encoder_tpu_torch/csrc/table_lookup.cu",
                     "dmmt_jpeg_encoder_tpu/ops/pallas_lookup.py:74, "
                     "dmmt_jpeg_encoder_tpu/ops/pallas_lookup.py:139"),
    "pack_emissions": ("dmmt_jpeg_encoder_tpu_torch/csrc/emission_pack.cu",
                       "dmmt_jpeg_encoder_tpu/bitstream/pallas_pack.py:174, "
                       "dmmt_jpeg_encoder_tpu/bitstream/pallas_pack.py:208"),
}
KERNEL_INFO.update({
    "plane_dct": ("dmmt_jpeg_encoder_tpu_torch/csrc/plane_dct.cu",
                  "dmmt_jpeg_encoder_tpu/ops/pallas_dct.py:92"),
    "plane_dct_mm": ("dmmt_jpeg_encoder_tpu_torch/csrc/mxu_dct.cu",
                     "dmmt_jpeg_encoder_tpu/ops/mxu_dct.py:162"),
    "phase1_mm": ("dmmt_jpeg_encoder_tpu_torch/csrc/fused_phase1.cu",
                  "dmmt_jpeg_encoder_tpu/ops/fused_phase1.py:238"),
    "block_dct_zz": ("dmmt_jpeg_encoder_tpu_torch/csrc/block_dct.cu",
                     "dmmt_jpeg_encoder_tpu/ops/fused.py:102"),
    "probe": ("dmmt_jpeg_encoder_tpu_torch/csrc/probe.cu",
              "dmmt_jpeg_encoder_tpu/utils/capability.py:117"),
    # no TPU kernel: the stuffing the JAX package does on the host
    "scan_stuff": ("dmmt_jpeg_encoder_tpu_torch/csrc/scan_stuff.cu",
                   "none (dmmt_jpeg_encoder_tpu/bitstream/device_pack.py finalize_scan_bytes)"),
    # the split arms of DMMT_P1_PREC=high (their own launch counts)
    "plane_dct_mm_high": ("dmmt_jpeg_encoder_tpu_torch/csrc/mxu_dct.cu",
                          "dmmt_jpeg_encoder_tpu/ops/mxu_dct.py:162"),
    "phase1_mm_high": ("dmmt_jpeg_encoder_tpu_torch/csrc/fused_phase1.cu",
                       "dmmt_jpeg_encoder_tpu/ops/fused_phase1.py:238"),
})
NEW_KERNELS = ("histogram", "table_lookup", "pack_emissions")
DCT_KERNELS = ("plane_dct", "plane_dct_mm", "phase1_mm", "block_dct_zz", "plane_dct_mm_high",
               "phase1_mm_high")
# each phase-1 route's kernel launches per image, slab group or fused chunk
# (the plane kernels: luma, then Cb and Cr stacked; the block kernel: luma,
# Cb, Cr)
ROUTE_LAUNCHES = {
    "p1_pallas": {"plane_dct": 2}, "p1_mxu": {"plane_dct_mm": 2}, "p1_fused1": {"phase1_mm": 1},
    "dct_simple": {"plane_dct_mm": 2}, "dct_separated": {"plane_dct_mm": 2},
    "dct_fused": {"block_dct_zz": 3},
    "p1_mxu_high": {"plane_dct_mm_high": 2}, "p1_fused1_high": {"phase1_mm_high": 1},
}
# Published H100 SXM peaks at a 700 W limit: HBM bytes/s, and float32 (and
# 32-bit integer) operations/s outside the tensor cores.
# The bench stage (phase 6): its rounds per metric, and the kernels its
# stages launch (the default route, DMMT_P1=fused1 and DMMT_HIST=matmul of
# the mode sweep, the probe of the sharded encode its collective
# measurement runs); every other kernel must not launch there.
BENCH_ROUNDS = 3
BENCH_KERNELS = ("phase1", "block_hist", "scan_pack", "histogram", "phase1_mm", "probe",
                 "scan_stuff")
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
# Operations per unit of work, counted from the kernels' arithmetic (an fma
# counts as two): phase 1 per pixel (color 20, P420 subsample 4, Arai row +
# column passes with divide and round 11.5 per coefficient x 1.5
# coefficients per pixel); histograms and scan pack per coefficient.
OPS_PHASE1_PER_PIXEL = 41
OPS_HIST_PER_COEFF = 10
OPS_PACK_PER_COEFF = 30
# weighted histogram per entry (two range compares, a weight test, an
# add), lookup per entry (two compares, a select), emission pack per live
# (block, slot) (offset add, shifts, masks, compares, two ORs) beside one
# length test per slot
OPS_HISTOGRAM_PER_ENTRY = 4
OPS_LOOKUP_PER_ENTRY = 3
OPS_EMIT_PER_SLOT = 12
# the phase-1 route kernels, per coefficient: two Arai passes (54
# operations per 8 outputs each) + divide + rounding; two 8-term
# contractions (4 products, 4 fmas, 3 adds: 15 each) + divide + rounding;
# per pixel of the fused matmul phase 1 (normalize 3, color 17, luma DCT 34
# and P420 chroma 2 x 34 / 4, subsample 2); per output of the block DCT
# (64 fmas + rounding)
OPS_ARAI_PER_COEFF = 18
OPS_MATMUL_DCT_PER_COEFF = 34
OPS_PHASE1_MM_PER_PIXEL = 73
OPS_BLOCK_DCT_PER_COEFF = 131
# the split arms (DMMT_P1_PREC=high), per coefficient: per pass the split
# of the value (two bf16 roundings, a subtract, two conversions back: 5)
# and three 8-term chains of 8 fmas (16 each) with their two adds; per
# pixel of the fused matmul phase 1, its count above with those passes in
# place of the two contractions (luma 106, P420 chroma 2 x 106 / 4)
OPS_MATMUL_DCT_HIGH_PER_COEFF = 2 * (5 + 3 * 16 + 2) + 4
OPS_PHASE1_MM_HIGH_PER_PIXEL = 3 + 17 + 106 + 53 + 2

# The multi-process encode (parallel/multihost.py), one process per rank:
# two gloo processes on card 0, each fixture at num_shards n (n / 2 shards
# per process); rank 0 writes each JPEG, every rank prints its launch counts.
DISTRIBUTED_CASES = (("4k_p420", 2), ("333x1001_p422", 4), ("7x17_p444", 2))
DISTRIBUTED_WORKER = r"""
import json, sys
sys.path[:0] = [sys.argv[4], sys.argv[4] + "/tests"]
import torch
import dmmt_jpeg_encoder_tpu_torch as port
from dmmt_jpeg_encoder_tpu_torch.kernels import build
from dmmt_jpeg_encoder_tpu_torch.parallel import multihost as mh
from torch_port_fixtures import FIXTURES, fixture_pixels

rank, port_no, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
mh.initialize_distributed(f"tcp://localhost:{port_no}", 2, rank, backend="gloo")
for name, n in json.loads(sys.argv[5]):
    f, px = FIXTURES[name], fixture_pixels(name)
    cfg = port.EncoderConfig(chroma_subsampling=port.ChromaSubsamplingPreset(f["preset"]),
                             quality=f["quality"], num_shards=n)
    r0, r1 = mh.local_row_range(f["height"], f["width"], cfg)
    jpeg = mh.encode_array_distributed(px[r0:r1] if r1 > r0 else None, f["height"], f["width"],
                                       f["maxval"], cfg, device=["cuda:0"] * (n // 2))
    assert (jpeg is None) == (rank != 0)
    if rank == 0:
        open(f"{out}.{name}.{n}", "wb").write(jpeg)
torch.distributed.destroy_process_group()
print(json.dumps(build.launch_counts()))
"""


def sharded_launches(n: int, images: int, groups: int, times: int = 1, p1=("phase1", 1),
                     hist: str = "fused", pack: str = "scan_pack", probes: int = 1) -> dict:
    """Every kernel's launches in a sharded encode of `times` runs of
    `images` images in `groups` phase-1 groups over n shards: per shard,
    p1 = (kernel, launches) per phase-1 call; per image and shard, the
    histograms ("fused": three block-histogram calls, "pallas": four
    weighted-histogram calls) and the pack ("scan_pack"; "staged": two
    lookups and one emission pack; "host": none on the card), or per group
    and shard one slab scan pack ("slab"); and the capability probe once
    per card (the run starts with no card probed)."""
    c = {k: 0 for k in KERNEL_INFO}
    c[p1[0]] = n * groups * p1[1] * times
    c["block_hist" if hist == "fused" else "histogram"] = (3 if hist == "fused" else 4) * n * images * times
    if pack == "scan_pack":
        c["scan_pack"] = n * images * times
    elif pack == "slab":
        c["scan_pack_slab"] = n * groups * times
    elif pack == "staged":
        c["table_lookup"], c["pack_emissions"] = 2 * n * images * times, n * images * times
    c["probe"] = probes
    return c


def two_dispatch_replays(n: int, pack: str = "fused_pack") -> dict:
    """The graph replays of n two-dispatch encode_array calls on one card:
    the first half's program and the pack's (pack "fused_pack", "pack" for
    the staged pack, None for the host scan backend) once each per call."""
    return {"pipeline": n, **({pack: n} if pack else {})}


def four_k_two_dispatch(off4, host4, none_new: dict) -> list[tuple]:
    """The 4K frame's two-dispatch paths: (label, environment, config,
    kernel launches, graph replays) of one encode_array call each."""
    return [
        ("two-dispatch, staged pack (DMMT_NO_FUSED_PACK=1)", {"DMMT_NO_FUSED_PACK": "1"}, off4,
         {"phase1": 1, "block_hist": 2, "scan_pack": 0, "scan_pack_slab": 0,
          "histogram": 0, "table_lookup": 2, "pack_emissions": 1}, two_dispatch_replays(1, "pack")),
        ("two-dispatch, DMMT_HIST=pallas", {"DMMT_HIST": "pallas"}, off4,
         {"phase1": 1, "block_hist": 0, "scan_pack": 1, "scan_pack_slab": 0, "histogram": 4,
          "table_lookup": 0, "pack_emissions": 0}, two_dispatch_replays(1)),
        ("two-dispatch, host scan backend", {}, host4,
         {"phase1": 1, "block_hist": 2, "scan_pack": 0, "scan_pack_slab": 0, **none_new},
         two_dispatch_replays(1, None)),
    ]


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


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


@contextlib.contextmanager
def scoped_env(env: dict):
    """Set environment variables for the block, then restore them."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


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


def check_equal(torch, errs: dict, name: str, what: str, kern, plain) -> None:
    """Hold a kernel's outputs (a tensor or a sequence of them) against its
    plain version's, exactly; record the largest difference."""
    kern = [kern] if isinstance(kern, torch.Tensor) else list(kern)
    plain = [plain] if isinstance(plain, torch.Tensor) else list(plain)
    if len(kern) != len(plain):
        raise AssertionError(f"{what}: {name} gives {len(kern)} outputs, plain {len(plain)}")
    for a, b in zip(kern, plain):
        if a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"{what}: {name} kernel != plain")
        errs[name] = max(errs[name], max_abs_err(torch, a, b))


def histogram_inputs(torch, parts) -> list[tuple]:
    """The weighted-histogram calls of DMMT_HIST=pallas and of the fused
    batch for each part ([B, N, 64] DPCM'd blocks, one group per image):
    DC categories over 16 bins, AC symbols weighted by nonzero over 256."""
    from dmmt_jpeg_encoder_tpu_torch.entropy.categorize import (
        ac_symbols_and_structure,
        magnitude_category,
    )

    calls = []
    for part in parts:
        b, flat = int(part.shape[0]), part.reshape(-1, 64)
        dc = magnitude_category(flat[:, 0]).reshape(b, -1)
        symbols, nz, _, _ = ac_symbols_and_structure(flat)
        calls += [(dc, torch.ones_like(dc), 16),
                  (symbols.reshape(b, -1), nz.reshape(b, -1).to(torch.int32), 256)]
    return calls


def staged_pack_inputs(torch, np, luma, cb, cr, lpm: int, flats: list, bits: list):
    """The staged pack of B images ([B, N, 64] blocks, per image flat
    tables and exact bits) as device_pack_scan_batch sets it up, each
    image's stream at a word-aligned base -> (its two lookup calls, rebuilt
    here as block_emissions makes them; emissions; boff; words needed + 2)."""
    from dmmt_jpeg_encoder_tpu_torch.bitstream.device_pack import (
        _stacked_tables,
        batch_emissions,
        chroma_index,
        interleave_scan,
        pack_values,
        unpack_values,
    )
    from dmmt_jpeg_encoder_tpu_torch.entropy.categorize import (
        ac_symbols_and_structure,
        magnitude_category,
    )

    n_words = [(int(b) + 31) // 32 for b in bits]
    word_off = np.concatenate([[0], np.cumsum(n_words)[:-1]]).astype(np.int64)
    b = int(luma.shape[0])
    codes, lens, word_base = unpack_values(
        torch.from_numpy(pack_values(flats, word_off)).to(luma.device), b)
    emissions, boff = batch_emissions(luma, cb, cr, lpm, codes, lens, word_base)
    # the lookups: each scan block's DC category and AC symbols, offset by
    # its table set (chroma), in each image's own combined tables
    scan = interleave_scan(luma.reshape(-1, 64), cb.reshape(-1, 64), cr.reshape(-1, 64),
                           b * int(cb.shape[1]), lpm)
    chroma = chroma_index(int(scan.shape[0]), lpm + 2, lpm, scan.device)
    dc_comb, ac_comb = _stacked_tables(codes, lens)
    symbols = ac_symbols_and_structure(scan)[0]
    calls = [((chroma * 16 + magnitude_category(scan[:, 0])).reshape(b, -1),
              dc_comb.reshape(b, 32)),
             ((chroma[:, None] * 256 + symbols).reshape(b, -1), ac_comb.reshape(b, 512))]
    return calls, emissions, boff, sum(n_words) + 2


def new_kernel_cases(torch, hist_calls, lookup_calls, emissions, boff, n_words):
    """(kernel, plain, library) callables of the weighted histogram, the
    lookup and the emission pack on one set of inputs; the library call is
    the one PyTorch call that computes the same function (bincount, gather),
    None for the emission pack."""
    from dmmt_jpeg_encoder_tpu_torch.bitstream.device_pack import pack_to_words
    from dmmt_jpeg_encoder_tpu_torch.bitstream.emission_pack import pack_emission_words
    from dmmt_jpeg_encoder_tpu_torch.ops.histogram import histogram_grouped, histogram_grouped_plain
    from dmmt_jpeg_encoder_tpu_torch.ops.lookup import table_lookup_grouped, table_lookup_grouped_plain

    # the library calls' argument types, made outside the timed calls
    bincount_in = [((s + torch.arange(s.shape[0], device=s.device)[:, None] * n).reshape(-1),
                    w.reshape(-1).to(torch.float32), s.shape[0] * n) for s, w, n in hist_calls]
    gather_in = [(t, s.to(torch.int64)) for s, t in lookup_calls]
    return {
        "histogram": (lambda: [histogram_grouped(*a) for a in hist_calls],
                      lambda: [histogram_grouped_plain(*a) for a in hist_calls],
                      lambda: [torch.bincount(s, weights=w, minlength=m) for s, w, m in bincount_in]),
        "table_lookup": (lambda: [table_lookup_grouped(*a) for a in lookup_calls],
                         lambda: [table_lookup_grouped_plain(*a) for a in lookup_calls],
                         lambda: [torch.gather(t, 1, s) for t, s in gather_in]),
        "pack_emissions": (lambda: pack_emission_words(*emissions, n_words, boff=boff),
                           lambda: pack_to_words(*emissions, n_words, boff),
                           None),
    }


def new_kernel_bounds(hist_calls, lookup_calls, emissions, n_words) -> dict:
    """Bounds of the three kernels' work: each input read once, each output
    written once; operations per entry as counted above. The emission pack
    needs every slot's length but a slot's value and offset only where the
    length is nonzero (most AC slots are empty), so of those two arrays it
    counts the 32-byte sectors (8 slots) of this run's data that hold a live
    slot, plus boff and the words."""
    n_hist = sum(s.numel() for s, _, _ in hist_calls)
    n_look = sum(s.numel() for s, _ in lookup_calls)
    n_blocks, n_emit = int(emissions[0].shape[0]), emissions[0].numel()
    live = emissions[1].reshape(-1) > 0
    n_live = int(live.sum())
    live_sectors = (live.nonzero()[:, 0] // 8).unique().numel()
    return {
        "histogram": bound(n_hist * 8 + sum(s.shape[0] * n * 4 for s, _, n in hist_calls),
                           n_hist * OPS_HISTOGRAM_PER_ENTRY),
        "table_lookup": bound(n_look * 8 + sum(t.numel() * 4 for _, t in lookup_calls),
                              n_look * OPS_LOOKUP_PER_ENTRY),
        "pack_emissions": bound(n_emit * 4 + 2 * live_sectors * 32 + n_blocks * 8 + n_words * 4,
                                n_emit + n_live * OPS_EMIT_PER_SLOT),
    }


def dct_kernel_cases(torch, rgb, maxval: int, luma_q, chroma_q, preset):
    """The four phase-1 route kernels, the two matmul ones also in their
    split arms (DMMT_P1_PREC=high), on one image's inputs as the routes
    give them: the plane kernels on the luma plane and on the Cb and Cr
    planes stacked, the fused matmul phase 1 on the pixels, the block
    kernel on the luma, Cb and Cr blocks. Returns ({kernel: (kernel,
    plain, library)} callables, {kernel: bound}). The library calls, timed
    only: one torch.einsum computing the same C X C^T products as the
    plane kernels (their DCT, by matmul, split or not, or by butterflies;
    no divide, no rounding) and one torch.matmul by M as the block kernel (no
    rounding), TF32 off; none for the fused matmul phase 1."""
    from dmmt_jpeg_encoder_tpu_torch.config import ChromaSubsamplingPreset
    from dmmt_jpeg_encoder_tpu_torch.ops.dct import dct_matrix
    from dmmt_jpeg_encoder_tpu_torch.ops.fused import (
        fused_dct_quantize_zigzag,
        fused_matrix,
        fused_reference,
    )
    from dmmt_jpeg_encoder_tpu_torch.ops.fused_phase1 import fused_phase1, fused_phase1_reference
    from dmmt_jpeg_encoder_tpu_torch.ops.geometry import blockize, entangled_blockize_p420
    from dmmt_jpeg_encoder_tpu_torch.ops.mxu_dct import mxu_dct_reference, plane_dct_quant_mxu
    from dmmt_jpeg_encoder_tpu_torch.ops.pallas_dct import plane_dct_quant
    from dmmt_jpeg_encoder_tpu_torch.pipeline import plane_dct_quant as arai_plain
    from dmmt_jpeg_encoder_tpu_torch.pipeline import ycbcr_planes

    dev = rgb.device
    lq, cq = (torch.from_numpy(q).to(dev) for q in (luma_q, chroma_q))
    y, cb, cr = ycbcr_planes(rgb, maxval, preset)
    planes = [(y, lq), (torch.cat([cb, cr]), cq)]
    luma_blocks = entangled_blockize_p420(y) if preset is ChromaSubsamplingPreset.P420 else blockize(y)
    blocks = [(b.contiguous(), q) for b, q in ((luma_blocks, luma_q), (blockize(cb), chroma_q),
                                              (blockize(cr), chroma_q))]
    mats = [torch.from_numpy(fused_matrix(q)).to(dev) for _, q in blocks]
    c = torch.from_numpy(dct_matrix()).to(dev)
    groups = [p.reshape(p.shape[0] // 8, 8, p.shape[1] // 8, 8) for p, _ in planes]

    def einsum_dct():
        return [torch.einsum("vy,aybx,ux->avbu", c, x, c) for x in groups]

    cases = {
        "plane_dct": (lambda: [plane_dct_quant(p, q) for p, q in planes],
                      lambda: [arai_plain(p, q) for p, q in planes], einsum_dct),
        "plane_dct_mm": (lambda: [plane_dct_quant_mxu(p, q) for p, q in planes],
                         lambda: [mxu_dct_reference(p, q) for p, q in planes], einsum_dct),
        "phase1_mm": (lambda: fused_phase1(rgb, maxval, lq, cq, preset),
                      lambda: fused_phase1_reference(rgb, maxval, lq, cq, preset), None),
        "plane_dct_mm_high": (lambda: [plane_dct_quant_mxu(p, q, split=True) for p, q in planes],
                              lambda: [mxu_dct_reference(p, q, split=True) for p, q in planes],
                              einsum_dct),
        "phase1_mm_high": (lambda: fused_phase1(rgb, maxval, lq, cq, preset, split=True),
                           lambda: fused_phase1_reference(rgb, maxval, lq, cq, preset, split=True),
                           None),
        "block_dct_zz": (lambda: [fused_dct_quantize_zigzag(b, q) for b, q in blocks],
                         lambda: [fused_reference(b, m) for (b, _), m in zip(blocks, mats)],
                         lambda: [torch.matmul(b.reshape(-1, 64), m) for (b, _), m in zip(blocks, mats)]),
    }
    n_plane = sum(p.numel() for p, _ in planes)
    n_block = sum(b.numel() for b, _ in blocks)
    n_coeff = y.numel() + cb.numel() + cr.numel()
    bounds = {
        "plane_dct": bound(n_plane * 6 + 2 * 64 * 4, n_plane * OPS_ARAI_PER_COEFF),
        "plane_dct_mm": bound(n_plane * 6 + 3 * 64 * 4, n_plane * OPS_MATMUL_DCT_PER_COEFF),
        "phase1_mm": bound(rgb.numel() * rgb.element_size() + n_coeff * 2 + 3 * 64 * 4,
                           rgb.numel() // 3 * OPS_PHASE1_MM_PER_PIXEL),
        "plane_dct_mm_high": bound(n_plane * 6 + 4 * 64 * 4, n_plane * OPS_MATMUL_DCT_HIGH_PER_COEFF),
        "phase1_mm_high": bound(rgb.numel() * rgb.element_size() + n_coeff * 2 + 4 * 64 * 4,
                                rgb.numel() // 3 * OPS_PHASE1_MM_HIGH_PER_PIXEL),
        "block_dct_zz": bound(n_block * 6 + 3 * 64 * 64 * 4, n_block * OPS_BLOCK_DCT_PER_COEFF),
    }
    return cases, bounds


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(REPO), str(REPO / "tests")]
    import dmmt_jpeg_encoder_tpu_torch as port
    from dmmt_jpeg_encoder_tpu_torch import onedispatch, programs
    from dmmt_jpeg_encoder_tpu_torch.bitstream.device_pack import (
        byteswap_words,
        exact_scan_bits,
        finalize_scan_bytes,
        interleave_scan,
        pack_scan_plain,
        pack_scan_slab_plain,
        pack_to_words,
    )
    from dmmt_jpeg_encoder_tpu_torch.bitstream.emission_pack import pack_emission_words
    from dmmt_jpeg_encoder_tpu_torch.bitstream.scan_stuff import (
        stuff_scan,
        stuff_scan_plain,
        stuffed_start,
        tail_layout,
    )
    from dmmt_jpeg_encoder_tpu_torch.bitstream.fused_pack import (
        fused_pack_words,
        fused_pack_words_slab,
    )
    from dmmt_jpeg_encoder_tpu_torch.debug.jpeg_decoder import decode_jpeg
    from dmmt_jpeg_encoder_tpu_torch.encoder import HuffmanTables, fused_max_blocks, slab_depth
    from dmmt_jpeg_encoder_tpu_torch.encoder import _jpeg as jpeg_bytes
    from dmmt_jpeg_encoder_tpu_torch.huffman.device_tables import (
        device_code_tables_batched,
        pad_dc_histogram,
    )
    from dmmt_jpeg_encoder_tpu_torch.io.ppm import write_ppm
    from dmmt_jpeg_encoder_tpu_torch.kernels import build
    from dmmt_jpeg_encoder_tpu_torch.onedispatch import blocks_per_image, pack_inputs
    from dmmt_jpeg_encoder_tpu_torch.ops.block_hist import (
        block_histograms_plain,
        fused_block_histograms,
    )
    from dmmt_jpeg_encoder_tpu_torch.ops.fused import (
        fused_dct_quantize_zigzag,
        fused_matrix,
        fused_reference,
    )
    from dmmt_jpeg_encoder_tpu_torch.ops.fused_arai import fused_arai_phase1
    from dmmt_jpeg_encoder_tpu_torch.ops.fused_phase1 import fused_phase1, fused_phase1_reference
    from dmmt_jpeg_encoder_tpu_torch.ops.geometry import padded_size
    from dmmt_jpeg_encoder_tpu_torch.ops.histogram import histogram_grouped, histogram_grouped_plain
    from dmmt_jpeg_encoder_tpu_torch.ops.lookup import table_lookup_grouped, table_lookup_grouped_plain
    from dmmt_jpeg_encoder_tpu_torch.ops.mxu_dct import division_check as mxu_division_check
    from dmmt_jpeg_encoder_tpu_torch.ops.mxu_dct import mxu_dct_reference, plane_dct_quant_mxu
    from dmmt_jpeg_encoder_tpu_torch.ops.pallas_dct import plane_dct_quant
    from dmmt_jpeg_encoder_tpu_torch.parallel import sharding
    from dmmt_jpeg_encoder_tpu_torch.pipeline import (
        dc_dpcm,
        image_layout,
        interleaved,
        phase1_zigzag_blocks,
        row_stack,
        run_device_pipeline_batch,
        ycbcr_planes,
    )
    from dmmt_jpeg_encoder_tpu_torch.pipeline import plane_dct_quant as arai_plain
    from dmmt_jpeg_encoder_tpu_torch.tables import quantization_table_pair
    from dmmt_jpeg_encoder_tpu_torch.tools.timing import device_ms
    from dmmt_jpeg_encoder_tpu_torch.utils import capability
    from dmmt_jpeg_encoder_tpu_torch.utils.capability import probe_add_one
    from dmmt_jpeg_encoder_tpu_torch.utils.device import as_device
    from dmmt_jpeg_encoder_tpu_torch.utils.native import load_native
    from torch_port_fixtures import (
        BATCH_FIXTURES,
        BLOCK_DCT_EDGE_N,
        BLOCK_HIST_EDGE_CASES,
        DECODE_PSNR_FLOOR_4K,
        EMISSION_PACK_EDGE_CASES,
        FIXTURES,
        HISTOGRAM_EDGE_CASES,
        LOOKUP_EDGE_SHAPES,
        PHASE1_EDGE_CASES,
        PLANE_DCT_EDGE_SHAPES,
        PLANE_MM_EDGE_SHAPES,
        ROUTE_BATCHES,
        ROUTES,
        SCAN_PACK_EDGE_CASES,
        SCAN_PACK_EDGE_MASKS,
        SCAN_PACK_SLAB_EDGES,
        SCAN_PACK_TILE,
        SCAN_PACK_TILE_WORDS,
        batch_frames,
        block_dct_edge_inputs,
        block_hist_edge_segments,
        emission_pack_edge_inputs,
        emission_pack_tile_arms,
        fixture_pixels,
        histogram_edge_inputs,
        lookup_edge_inputs,
        phase1_edge_pixels,
        plane_mm_edge_inputs,
        psnr,
        random_blocks,
        scan_pack_edge_blocks,
        scan_pack_edge_mask,
        scan_pack_tables,
        load_batch_goldens,
        load_goldens,
        load_route_goldens,
        route_env,
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
    library = {k: None for k in KERNEL_INFO}
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

        def k2():  # as the encodes call it: the chroma as two segments
            return fused_block_histograms(blocks[0]), fused_block_histograms((blocks[1], blocks[2]))

        def p2():
            return block_histograms_plain(blocks[0]), block_histograms_plain(chroma)

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
        # with the sharded encode's `valid` mask: the first half of the
        # MCUs (a shard's prefix), and no block at all
        n_scan = int(scan.shape[0])
        masks = {"prefix": (torch.arange(n_scan, device=dev)
                            < n_scan // (lpm + 2) // 2 * (lpm + 2)).to(torch.int32),
                 "none": torch.zeros(n_scan, dtype=torch.int32, device=dev)}
        for mname, mask in masks.items():
            wv = fused_pack_words(*args, valid=mask)
            check_equal(torch, errs, "scan_pack", f"{name} valid {mname}", wv,
                        pack_scan_plain(*args, valid=mask))
            if mname == "none" and (int(wv[1].item()) != 0 or bool(wv[0].any())):
                raise AssertionError(f"{name}: scan_pack with no valid block emitted bits")
        log(f"{name}: scan_pack with valid masks (prefix {int(masks['prefix'].sum())} of {n_scan} "
            "blocks, none) == plain")
        # the stuffing behind the pack, on copies of its words
        words_k, words_p, n_raw = wk[0].clone(), wk[0].cpu(), (int(wk[1]) + 7) // 8
        n_stuffed = int(stuff_scan(words_k, wk[1]))
        start = stuffed_start(int(wk[1]))
        stuffed = words_k.view(torch.uint8)[start : start + n_stuffed].cpu().numpy().tobytes()
        if n_stuffed != int(stuff_scan_plain(words_p, wk[1].cpu())) or n_stuffed < n_raw \
                or stuffed != words_p.view(torch.uint8)[start : start + n_stuffed].numpy().tobytes() \
                or stuffed != finalize_scan_bytes(wk[0].cpu().numpy(), int(wk[1])):
            raise AssertionError(f"{name}: scan_stuff kernel != plain or the host's stuffing")
        log(f"{name}: scan_stuff == plain == the host's stuffing ({n_raw} -> {n_stuffed} bytes)")
        # the weighted histogram, the lookup and the emission pack on this
        # image's two-dispatch inputs (DMMT_HIST=pallas, DMMT_NO_FUSED_PACK=1)
        bits = int(wk[1].item())
        hist_calls = histogram_inputs(torch, [blocks[0][None], chroma[None]])
        flats = [tuple(zip(tables["codes_flat"].cpu().numpy(), tables["lens_flat"].cpu().numpy()))]
        lookups, emissions, boff, n_words7 = staged_pack_inputs(
            torch, np, blocks[0][None], blocks[1][None], blocks[2][None], lpm, flats, [bits])
        cases = new_kernel_cases(torch, hist_calls, lookups, emissions, boff, n_words7)
        for kname, (kf, pf, _) in cases.items():
            check_equal(torch, errs, kname, name, kf(), pf())
        words7, bits7 = cases["pack_emissions"][0]()
        if int(bits7) != bits or not torch.equal(byteswap_words(words7)[: n_words7 - 2],
                                                 wk[0][: n_words7 - 2]):
            raise AssertionError(f"{name}: staged pack != scan-pack kernel")
        log(f"{name}: kernels == plain (blocks {int(scan.shape[0])}, bits {bits}; "
            f"{len(lookups)} lookups, staged pack == scan pack)")
        # the plane and block routes' color and subsample run as plain torch
        # on the card: their floats must equal the CPU's (which the CPU
        # tests hold against the JAX package)
        for a, b in zip(ycbcr_planes(rgb, maxval, preset), ycbcr_planes(rgb.cpu(), maxval, preset)):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"{name}: ycbcr_planes on the card != on the CPU")
        tables_np = quantization_table_pair(port.QuantizationTablePreset.SPECIFICATION, f["quality"])
        dct_cases, dct_bounds = dct_kernel_cases(torch, rgb, maxval, *tables_np, preset)
        for kname, (kf, pf, _) in dct_cases.items():
            check_equal(torch, errs, kname, name, kf(), pf())
        log(f"{name}: phase-1 route kernels == plain ({', '.join(DCT_KERNELS)}); "
            "route color planes on the card == on the CPU")

        if name == "4k_p420":
            cpu = phase1_zigzag_blocks(rgb.cpu(), maxval, lq.cpu(), cq.cpu(), preset)
            for a, b in zip(kern, cpu):
                if not torch.equal(a.cpu(), b):
                    raise AssertionError("4k_p420: phase1 kernel != plain on the CPU")
            log("4k_p420: phase1 kernel == plain on the CPU")
            for kname, kf, pf in (("phase1", k1, p1), ("block_hist", k2, p2), ("scan_pack", k3, p3)):
                timing[kname] = (device_ms(kf), device_ms(pf))
                log(f"4k {kname}: kernel {timing[kname][0]:.4f} ms, plain {timing[kname][1]:.4f} ms")
            prefix = masks["prefix"]
            t_kv = device_ms(lambda: fused_pack_words(*args, valid=prefix))
            t_pv = device_ms(lambda: pack_scan_plain(*args, valid=prefix))
            n_valid = int(prefix.sum())
            bits_v = fused_pack_words(*args, valid=prefix)[1].tolist()
            b_v = bound(pack_bytes(n_valid, 1, bits_v) + n_scan * 4, n_valid * 64 * OPS_PACK_PER_COEFF)
            log(f"4k scan_pack with a valid prefix ({n_valid} of {n_scan} blocks): kernel "
                f"{t_kv:.4f} ms, plain {t_pv:.4f} ms, mask-free kernel {timing['scan_pack'][0]:.4f} ms, "
                f"bound {b_v[0]:.4f} ms ({b_v[1]})")
            bounds.update(new_kernel_bounds(hist_calls, lookups, emissions, n_words7))
            for kname, (kf, pf, lf) in cases.items():
                timing[kname] = (device_ms(kf), device_ms(pf))
                library[kname] = device_ms(lf) if lf else None
                log(f"4k {kname}: kernel {timing[kname][0]:.4f} ms, plain {timing[kname][1]:.4f} ms, "
                    f"library {library[kname]}, bound {bounds[kname][0]:.4f} ms")
            bounds.update(dct_bounds)
            prep_ms = device_ms(lambda: ycbcr_planes(rgb, maxval, preset))
            log(f"4k ycbcr_planes (color and subsample of the plane and block routes, plain torch "
                f"before their kernel): {prep_ms:.4f} ms")
            for kname, (kf, pf, lf) in dct_cases.items():
                timing[kname] = (device_ms(kf), device_ms(pf))
                library[kname] = device_ms(lf) if lf else None
                log(f"4k {kname}: kernel {timing[kname][0]:.4f} ms, plain {timing[kname][1]:.4f} ms, "
                    f"library {library[kname]}, bound {bounds[kname][0]:.4f} ms ({bounds[kname][1]})")
            n_blocks, n_px = int(scan.shape[0]), rgb.numel() // 3
            coeff_bytes = n_blocks * 128
            bounds["phase1"] = bound(rgb.numel() * rgb.element_size() + coeff_bytes + 2 * 64 * 4,
                                     n_px * OPS_PHASE1_PER_PIXEL)
            bounds["block_hist"] = bound(coeff_bytes + 2 * 272 * 4,
                                         n_blocks * 64 * OPS_HIST_PER_COEFF)
            bounds["scan_pack"] = bound(pack_bytes(n_blocks, 1, wk[1].tolist()),
                                        n_blocks * 64 * OPS_PACK_PER_COEFF)
            # each call on a state region zeroed first, as the pack's fill
            # leaves it; the fill is timed alone and taken out
            state = words_k.view(torch.uint8)[tail_layout(4 * n_words)[1] :]

            def k_stuff():
                state.zero_()
                return stuff_scan(words_k, wk[1])

            t_fill = device_ms(state.zero_)
            timing["scan_stuff"] = (device_ms(k_stuff) - t_fill,
                                    device_ms(lambda: stuff_scan_plain(words_p, wk[1].cpu())))
            bounds["scan_stuff"] = bound(n_raw + n_stuffed, 0)
            log(f"4k scan_stuff: kernel {timing['scan_stuff'][0]:.4f} ms (with its state's fill "
                f"{timing['scan_stuff'][0] + t_fill:.4f}, the fill {t_fill:.4f}), plain "
                f"{timing['scan_stuff'][1]:.4f} ms, bound {bounds['scan_stuff'][0]:.4f} ms")

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
        scans, tables, _ = pack_inputs(rgb, b, f["maxval"], config_of(f), *quantization_table_pair(
            port.QuantizationTablePreset.SPECIFICATION, f["quality"]))
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
        # with a [B, N] valid mask: image i keeps the first (i + 1) / (B + 1)
        # of its MCUs; and with no valid block
        n_scan, stride = int(scans.shape[1]), lpm + 2
        keep = torch.tensor([n_scan // stride * (i + 1) // (b + 1) * stride for i in range(b)],
                            device=dev)
        valid = (torch.arange(n_scan, device=dev)[None] < keep[:, None]).to(torch.int32)
        for mname, mask in (("prefix", valid), ("none", torch.zeros_like(valid))):
            wv = fused_pack_words_slab(scans, stride, lpm, codes, lens, n_words, valid=mask)
            check_equal(torch, errs, "scan_pack_slab", f"{name} valid {mname}", wv,
                        pack_scan_slab_plain(scans, stride, lpm, codes, lens, n_words, valid=mask))
            singles_v = [fused_pack_words(scans[i], stride, lpm, codes[i], lens[i], n_words,
                                          valid=mask[i]) for i in range(b)]
            check_equal(torch, errs, "scan_pack_slab", f"{name} valid {mname} vs {b} scan_pack",
                        wv, (torch.stack([w for w, _ in singles_v]),
                             torch.cat([t for _, t in singles_v])))
            if mname == "none" and (bool(wv[1].any()) or bool(wv[0].any())):
                raise AssertionError(f"{name}: scan_pack_slab with no valid block emitted bits")
        log(f"{name}: scan_pack_slab with [{b}, {n_scan}] valid masks (per-image prefixes, none) "
            f"== plain == {b} scan_pack calls with valid")
        if name == "batch_1080p_p420":
            t_kv = device_ms(lambda: fused_pack_words_slab(scans, stride, lpm, codes, lens,
                                                                n_words, valid=valid))
            t_pv = device_ms(lambda: pack_scan_slab_plain(scans, stride, lpm, codes, lens,
                                                               n_words, valid=valid))
            n_valid = int(valid.sum())
            bits_v = fused_pack_words_slab(scans, stride, lpm, codes, lens, n_words,
                                           valid=valid)[1].tolist()
            b_v = bound(pack_bytes(n_valid, b, bits_v) + b * n_scan * 4,
                        n_valid * 64 * OPS_PACK_PER_COEFF)
            log(f"1080p x {b} scan_pack_slab with a [B, N] valid mask ({n_valid} of {b * n_scan} "
                f"blocks): kernel {t_kv:.4f} ms, plain {t_pv:.4f} ms, bound {b_v[0]:.4f} ms "
                f"({b_v[1]})")
            t_k4, t_plain, t_each = device_ms(k4), device_ms(p4), device_ms(k3_each)
            timing["scan_pack_slab"] = (t_k4, t_plain)
            n_blocks = b * int(scans.shape[1])
            bounds["scan_pack_slab"] = bound(pack_bytes(n_blocks, b, wk[1].tolist()),
                                             n_blocks * 64 * OPS_PACK_PER_COEFF)
            log(f"1080p x {b} scan_pack_slab: kernel {t_k4:.4f} ms, {b} scan_pack calls "
                f"{t_each:.4f} ms, plain {t_plain:.4f} ms, "
                f"bound {bounds['scan_pack_slab'][0]:.4f} ms")

    # the fused batch's grouped histogram, grouped lookup and per-image
    # stream bases, on the 1080p x 16 group
    f = BATCH_FIXTURES["batch_1080p_p420"]
    cfg = port.EncoderConfig(chroma_subsampling=port.ChromaSubsamplingPreset(f["preset"]),
                             quality=f["quality"])
    lq, cq = quantization_table_pair(cfg.quantization_preset, cfg.quality)
    b = f["n"]
    luma, cb, cr, *hists = run_device_pipeline_batch(np.stack(batches["batch_1080p_p420"]),
                                                     f["maxval"], cfg, lq, cq, device=dev)
    flats, bits = [], []
    for row in torch.cat(hists, dim=1).cpu().numpy():
        parts = np.split(row, [16, 272, 288])
        flat = HuffmanTables.from_host_histograms(*parts).flat()
        flats.append(flat)
        bits.append(exact_scan_bits(parts, *flat))
    lpm = cfg.chroma_subsampling.luma_blocks_per_mcu
    hist_calls = histogram_inputs(torch, [luma, torch.cat([cb, cr], dim=1)])
    lookups, emissions, boff, n_words7 = staged_pack_inputs(torch, np, luma, cb, cr, lpm, flats, bits)
    cases = new_kernel_cases(torch, hist_calls, lookups, emissions, boff, n_words7)
    group_bounds = new_kernel_bounds(hist_calls, lookups, emissions, n_words7)
    for kname, (kf, pf, lf) in cases.items():
        check_equal(torch, errs, kname, "batch_1080p_p420 fused", kf(), pf())
        t_k, t_p, t_l = device_ms(kf), device_ms(pf), device_ms(lf) if lf else None
        log(f"1080p x {b} fused {kname}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, library {t_l}, "
            f"bound {group_bounds[kname][0]:.4f} ms ({group_bounds[kname][1]})")
    log(f"batch_1080p_p420 fused: grouped kernels == plain ({b} x {int(luma.shape[1])} luma blocks, "
        f"{len(lookups)} lookups, word-aligned per-image stream bases)")
    del luma, cb, cr, hists, hist_calls, lookups, emissions, boff, cases

    # the capability probe on its [8, 128] float32 tile (called directly:
    # kernels_capable launches it inside the sharded paths below)
    x = torch.arange(8 * 128, dtype=torch.float32, device=dev).reshape(8, 128)
    probe_out = probe_add_one(x)
    if not torch.equal(probe_out, x + 1):
        raise AssertionError("probe kernel != plain (x + 1)")
    errs["probe"] = float((probe_out - (x + 1)).abs().max().item())
    timing["probe"] = (device_ms(lambda: probe_add_one(x)), device_ms(lambda: x + 1))
    library["probe"] = device_ms(lambda: torch.add(x, 1.0))
    bounds["probe"] = bound(2 * x.numel() * 4, x.numel())
    log(f"probe: kernel == plain; kernel {timing['probe'][0]:.4f} ms, plain {timing['probe'][1]:.4f} "
        f"ms, library (torch.add) {library['probe']:.4f} ms, bound {bounds['probe'][0]:.7f} ms")

    # the edge shapes of the block DCT's and the lookup's tilings
    # (tests/torch_port_fixtures.py), each also through a view that starts
    # 4 bytes past a 16-byte boundary (the kernels' unaligned paths),
    # against the plain versions, exactly
    for n in BLOCK_DCT_EDGE_N:
        blocks_np, q = block_dct_edge_inputs(n)
        x = torch.from_numpy(blocks_np).to(dev)
        want = fused_reference(x, torch.from_numpy(fused_matrix(q)).to(dev))
        shifted = torch.empty(n * 64 + 1, dtype=torch.float32, device=dev)
        shifted[1:] = x.reshape(-1)
        for label, xin in (("", x), (" unaligned", shifted[1:].reshape(n, 8, 8))):
            check_equal(torch, errs, "block_dct_zz", f"edge N={n}{label}",
                        fused_dct_quantize_zigzag(xin, q), want)
    for g, m, t in LOOKUP_EDGE_SHAPES:
        sym_np, tab_np = lookup_edge_inputs(g, m, t, in_range=False)
        sym = torch.from_numpy(sym_np).to(dev)
        tab = torch.from_numpy(tab_np.astype(np.int32)).to(dev)
        want = table_lookup_grouped_plain(sym, tab)
        shifted = torch.empty(g * m + 1, dtype=torch.int32, device=dev)
        shifted[1:] = sym.reshape(-1)
        for label, sin in (("", sym), (" unaligned", shifted[1:].reshape(g, m))):
            check_equal(torch, errs, "table_lookup", f"edge G={g} m={m} T={t}{label}",
                        table_lookup_grouped(sin, tab), want)
    log(f"edge shapes: block_dct_zz == plain for N in {BLOCK_DCT_EDGE_N}; table_lookup == plain "
        f"on {len(LOOKUP_EDGE_SHAPES)} (G, m, T) shapes with symbols -1, T, T + 1; both also "
        "from unaligned views")

    # the scan pack's, the block histograms' and the two phase 1s' edge cases
    # (tests/torch_port_fixtures.py), each also from a view 4 bytes past a
    # 16-byte boundary, against the plain versions, exactly
    def unaligned(t):
        n_bytes = t.numel() * t.element_size()
        flat = torch.empty(n_bytes + 32, dtype=torch.uint8, device=dev)
        off = (16 - flat.data_ptr() % 16) % 16 + 4
        view = flat[off : off + n_bytes]
        view.copy_(t.reshape(-1).view(torch.uint8))
        view = view.view(t.dtype).view(t.shape)
        assert view.data_ptr() % 16 == 4
        return view

    tile_arms = {}
    for case in SCAN_PACK_EDGE_CASES:
        blocks_np, stride, lpm = scan_pack_edge_blocks(case)
        codes, lens = (torch.from_numpy(t).to(dev) for t in scan_pack_tables(blocks_np, stride, lpm))
        x = torch.from_numpy(blocks_np).to(dev)
        n_words = x.shape[0] * 64 + 2
        want = pack_scan_plain(x, stride, lpm, codes, lens, n_words)
        for label, xin in (("", x), (" unaligned", unaligned(x))):
            check_equal(torch, errs, "scan_pack", f"edge {case}{label}",
                        fused_pack_words(xin, stride, lpm, codes, lens, n_words), want)
        # which arm each tile takes: over-full past the shared word buffer
        tiles = [int(pack_scan_plain(x[i : i + SCAN_PACK_TILE], stride, lpm, codes, lens,
                                     SCAN_PACK_TILE * 64 + 2)[1]) for i in range(0, x.shape[0], SCAN_PACK_TILE)]
        tile_arms[case] = ["over-full" if b > 32 * (SCAN_PACK_TILE_WORDS - 1) else "shared" for b in tiles]
        if case == "tiles3+5":
            for mname in SCAN_PACK_EDGE_MASKS:
                mask = torch.from_numpy(scan_pack_edge_mask(mname, x.shape[0])).to(dev)
                check_equal(torch, errs, "scan_pack", f"edge {case} valid {mname}",
                            fused_pack_words(x, stride, lpm, codes, lens, n_words, valid=mask),
                            pack_scan_plain(x, stride, lpm, codes, lens, n_words, valid=mask))
    if "over-full" not in tile_arms["overfull"] or "shared" not in tile_arms["overfull"]:
        raise AssertionError(f"scan_pack edge: the over-full case's tiles take {tile_arms['overfull']}")
    for slab_cases in SCAN_PACK_SLAB_EDGES:
        cases = [scan_pack_edge_blocks(c) for c in slab_cases]
        stride, lpm = cases[0][1:]
        tabs = [scan_pack_tables(*c) for c in cases]
        xs = torch.from_numpy(np.stack([c[0] for c in cases])).to(dev)
        codes, lens = (torch.from_numpy(np.stack([t[i] for t in tabs])).to(dev) for i in (0, 1))
        n_words = xs.shape[1] * 64 + 2
        want = pack_scan_slab_plain(xs, stride, lpm, codes, lens, n_words)
        for label, xin in (("", xs), (" unaligned", unaligned(xs))):
            got = fused_pack_words_slab(xin, stride, lpm, codes, lens, n_words)
            check_equal(torch, errs, "scan_pack_slab", f"edge B={len(cases)}{label}", got, want)
        singles = [fused_pack_words(xs[i], stride, lpm, codes[i], lens[i], n_words) for i in range(len(cases))]
        check_equal(torch, errs, "scan_pack_slab", f"edge B={len(cases)} vs scan_pack", got,
                    (torch.stack([w for w, _ in singles]), torch.cat([t for _, t in singles])))
    log(f"edge cases: scan_pack == plain on {len(SCAN_PACK_EDGE_CASES)} cases (tiles' arms "
        f"{tile_arms}), with valid masks {SCAN_PACK_EDGE_MASKS}; scan_pack_slab == plain == scan_pack "
        f"for B in {[len(c) for c in SCAN_PACK_SLAB_EDGES]}; all also from unaligned views")
    for case in BLOCK_HIST_EDGE_CASES:
        segs = [torch.from_numpy(x).to(dev) for x in block_hist_edge_segments(case)]
        whole, n_valid = torch.cat(segs), case[2]
        want = block_histograms_plain(whole[: len(whole) if n_valid is None else n_valid])
        for label, xin in (("", segs), (" unaligned", [unaligned(x) if x.numel() else x for x in segs])):
            got = fused_block_histograms(tuple(xin) if len(xin) > 1 else xin[0], n_valid)
            check_equal(torch, errs, "block_hist", f"edge {case}{label}", got, want)
    log(f"edge cases: block_hist == plain on {len(BLOCK_HIST_EDGE_CASES)} (content, segments, "
        "n_valid) cases, also from unaligned views")
    for h, w, pname, maxval in PHASE1_EDGE_CASES:
        preset = port.ChromaSubsamplingPreset(pname)
        lq, cq = (torch.from_numpy(t).to(dev) for t in quantization_table_pair(
            port.QuantizationTablePreset.SPECIFICATION, None))
        rgb = torch.from_numpy(phase1_edge_pixels(h, w, maxval)).to(dev)
        want = phase1_zigzag_blocks(rgb, maxval, lq, cq, preset)
        want_mm = fused_phase1_reference(rgb, maxval, lq, cq, preset)
        want_high = fused_phase1_reference(rgb, maxval, lq, cq, preset, split=True)
        for label, xin in (("", rgb), (" unaligned", unaligned(rgb))):
            what = f"edge {h}x{w} {pname} maxval {maxval}{label}"
            check_equal(torch, errs, "phase1", what, fused_arai_phase1(xin, maxval, lq, cq, preset), want)
            check_equal(torch, errs, "phase1_mm", what, fused_phase1(xin, maxval, lq, cq, preset), want_mm)
            check_equal(torch, errs, "phase1_mm_high", what,
                        fused_phase1(xin, maxval, lq, cq, preset, split=True), want_high)
    log(f"edge cases: phase1, phase1_mm and phase1_mm_high == plain on {len(PHASE1_EDGE_CASES)} "
        "(H, W, preset, maxval) cases, also from unaligned views")
    for h, w in PLANE_MM_EDGE_SHAPES:
        plane_np, q_np = plane_mm_edge_inputs(h, w)
        plane, q = torch.from_numpy(plane_np).to(dev), torch.from_numpy(q_np).to(dev)
        want, want_high = mxu_dct_reference(plane, q), mxu_dct_reference(plane, q, split=True)
        for label, xin in (("", plane), (" unaligned", unaligned(plane))):
            check_equal(torch, errs, "plane_dct_mm", f"edge {h}x{w}{label}",
                        plane_dct_quant_mxu(xin, q), want)
            check_equal(torch, errs, "plane_dct_mm_high", f"edge {h}x{w}{label}",
                        plane_dct_quant_mxu(xin, q, split=True), want_high)
    # the division the kernel uses for 8-bit tables, over every finite x
    t0 = time.perf_counter()
    _, coefficients = mxu_division_check(dev)
    quotients, _ = mxu_division_check(dev, 0.25)
    if coefficients or quotients:
        raise AssertionError(f"plane_dct_mm division: {coefficients} coefficients over every finite x, "
                             f"{quotients} quotients with |x| >= 0.25 differ from __fdiv_rn's")
    log(f"plane_dct_mm division by q in 1..255: every finite x's coefficient, and every quotient "
        f"with |x| >= 0.25, equal __fdiv_rn's ({time.perf_counter() - t0:.1f} s)")
    log(f"edge shapes: plane_dct_mm and plane_dct_mm_high == plain on {len(PLANE_MM_EDGE_SHAPES)} "
        "(H, W) planes "
        "(saturated groups, DCs on x.5 after / q, a table past 8 bits), also from unaligned views")
    emit_arms = {}
    for case in EMISSION_PACK_EDGE_CASES:
        values, lens, offs, bits, n_words, boff = emission_pack_edge_inputs(case)
        em = [torch.from_numpy(x).to(dev) for x in (values, lens, offs, bits)]
        tb = None if boff is None else torch.from_numpy(boff).to(dev)
        want = pack_to_words(*em, n_words, tb)
        for label, ein in (("", em), (" unaligned", [*(unaligned(x) for x in em[:3]), em[3]])):
            check_equal(torch, errs, "pack_emissions", f"edge {case}{label}",
                        pack_emission_words(*ein, n_words, boff=tb), want)
        emit_arms[case] = emission_pack_tile_arms(bits, boff)
    reached = {arm for arms in emit_arms.values() for arm in arms}
    if reached != {"empty", "shared", "over-full"}:
        raise AssertionError(f"pack_emissions edge: the cases' tiles take only {sorted(reached)}")
    arm_counts = {arm: sum(arms.count(arm) for arms in emit_arms.values()) for arm in sorted(reached)}
    log(f"edge cases: pack_emissions == plain on {len(EMISSION_PACK_EDGE_CASES)} (content, N, "
        f"images, short) cases (tiles by arm {arm_counts}), also from unaligned views")
    for case in HISTOGRAM_EDGE_CASES:
        g, m, n_bins, content = case
        sym, wts = (torch.from_numpy(x).to(dev) for x in histogram_edge_inputs(case))
        want = histogram_grouped_plain(sym, wts, n_bins)
        views = [("", sym, wts)]
        if m:
            views += [(" unaligned", unaligned(sym), unaligned(wts)),
                      (" unaligned symbols only", unaligned(sym), wts)]
        for label, s_in, w_in in views:
            check_equal(torch, errs, "histogram", f"edge {case}{label}",
                        histogram_grouped(s_in, w_in, n_bins), want)
    # the ticket state, the block histograms' on each stream: calls in turn
    # on one stream, the block histograms between them, then on another (a
    # case of many CTAs, each taking a ticket)
    state_case = (3, 300_001, 16, "in_range")
    sym, wts = (torch.from_numpy(x).to(dev) for x in histogram_edge_inputs(state_case))
    want = histogram_grouped_plain(sym, wts, state_case[2])
    state_blocks = torch.from_numpy(random_blocks(17, 389)).to(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    for label, stream in (("one stream", torch.cuda.current_stream(dev)), ("a second stream", side)):
        with torch.cuda.stream(stream):
            outs = [histogram_grouped(sym, wts, want.shape[1]), fused_block_histograms(state_blocks),
                    histogram_grouped(sym, wts, want.shape[1])]
        stream.synchronize()
        for k in (0, 2):
            check_equal(torch, errs, "histogram", f"edge state: call {k} in turn on {label}", outs[k], want)
        check_equal(torch, errs, "block_hist", f"edge state: between the histograms on {label}", outs[1],
                    block_histograms_plain(state_blocks))
    log(f"edge cases: histogram == plain on {len(HISTOGRAM_EDGE_CASES)} (G, M, n_bins, content) "
        "cases, also from unaligned views (both, and the symbols alone); in turn with the block "
        "histograms on one stream and on a second")
    for h, w in PLANE_DCT_EDGE_SHAPES:
        plane_np, q_np = plane_mm_edge_inputs(h, w)
        plane, q = torch.from_numpy(plane_np).to(dev), torch.from_numpy(q_np).to(dev)
        want = arai_plain(plane, q)
        tables = [("", q)] + ([(" uint8 table", q.to(torch.uint8))] if q_np.max() <= 255 else [])
        for label, xin in (("", plane), (" unaligned", unaligned(plane))):
            for qlabel, qin in tables:
                check_equal(torch, errs, "plane_dct", f"edge {h}x{w}{label}{qlabel}",
                            plane_dct_quant(xin, qin), want)
    log(f"edge shapes: plane_dct == plain on {len(PLANE_DCT_EDGE_SHAPES)} (H, W) planes "
        "(saturated groups, DCs on x.5 after / q, 8-bit tables also as uint8, a table past 8 "
        "bits), also from unaligned views")

    # --- 4. end to end -----------------------------------------------------
    launches = {k: 0 for k in KERNEL_INFO}

    replays = {k: 0 for k in build.REPLAYS}

    def run_path(label, fn, expect, replayed=None):
        """Drive one path with the counts reset just before and read just
        after; `expect` maps kernel -> required count (None: at least one),
        `replayed` (when given) one-dispatch program kind -> graph replays,
        every other kind 0."""
        build.reset_launch_counts()
        result = fn()
        counts, replay = build.launch_counts(), build.replay_counts()
        log(f"{label} launches: {counts}; graph replays: {replay}")
        for k, want in expect.items():
            if (counts[k] == 0) if want is None else (counts[k] != want):
                raise AssertionError(f"{label}: {k} launched {counts[k]} times, expected "
                                     f"{'at least one' if want is None else want}")
        if replayed is not None and replay != {**dict.fromkeys(replay, 0), **replayed}:
            raise AssertionError(f"{label}: graph replays {replay}, expected {replayed}")
        for k, n in counts.items():
            launches[k] += n
        for k, n in replay.items():
            replays[k] += n
        return result

    def check_golden(name, jpeg, label):
        if sha256(jpeg) != goldens[name]["jpeg_sha256"] or len(jpeg) != goldens[name]["jpeg_len"]:
            raise AssertionError(f"{name} {label}: cuda JPEG differs from the JAX golden "
                                 f"({len(jpeg)} bytes)")
        log(f"{name} {label}: cuda bytes == JAX golden ({len(jpeg)} bytes)")

    none_new = {k: 0 for k in NEW_KERNELS + DCT_KERNELS}
    n_fix = len(FIXTURES)
    configs = {name: config_of(f) for name, f in FIXTURES.items()}
    off = {name: dataclasses.replace(c, one_dispatch="off") for name, c in configs.items()}
    for label, cfgs, expect in (
        ("one-dispatch", configs, {"phase1": None, "block_hist": None, "scan_pack": None,
                                   "scan_pack_slab": 0, **none_new}),
        ("one_dispatch=off", off, {"phase1": n_fix, "block_hist": 2 * n_fix, "scan_pack": n_fix,
                                   "scan_pack_slab": 0, **none_new}),
    ):
        outputs = run_path(f"single-image fixtures, {label}", lambda: {
            name: port.encode_array(images[name], f["maxval"], cfgs[name], device=dev)
            for name, f in FIXTURES.items()
        }, expect, {"onedispatch": n_fix} if cfgs is configs else two_dispatch_replays(n_fix))
        for name, jpeg in outputs.items():
            check_golden(name, jpeg, label)

    four_k, cfg4 = images["4k_p420"], configs["4k_p420"]
    host4 = dataclasses.replace(cfg4, scan_backend="host")
    for label, env, cfg, expect, replayed in four_k_two_dispatch(off["4k_p420"], host4, none_new):
        with scoped_env(env):
            jpeg = run_path(f"4k_p420 {label}", lambda: port.encode_array(four_k, 255, cfg, device=dev),
                            expect, replayed)
        check_golden("4k_p420", jpeg, label)

    arms = {"slab": {"DMMT_SLAB_ONEPACK": "0"}, "slab_onepack": {"DMMT_SLAB_ONEPACK": "1"},
            "per_image": {"DMMT_SLAB": "0"}}
    for name in ("batch_1080p_p420", "batch_4k_p420"):
        f, frames = BATCH_FIXTURES[name], batches[name]
        cfg = config_of(f)
        mpix = f["n"] * f["height"] * f["width"] / 1e6
        want = [g["jpeg_sha256"] for g in batch_goldens[name]]
        rates = {}
        for arm, env in arms.items():
            with scoped_env(env):
                depth = slab_depth(frames, cfg)
                groups = -(-f["n"] // depth)
                if (depth > 1) != (arm != "per_image"):
                    raise AssertionError(f"{name} {arm}: the gate chose depth {depth}")
                expect = {"phase1": groups if depth > 1 else f["n"], "block_hist": 2 * f["n"],
                          "scan_pack": 0 if arm == "slab_onepack" else f["n"],
                          "scan_pack_slab": groups if arm == "slab_onepack" else 0, **none_new}

                def batch():
                    return port.encode_batch(frames, f["maxval"], cfg, device=dev)

                out = run_path(f"{name} {arm} (depth {depth})", batch, expect,
                               {"onedispatch_slab": groups} if depth > 1 else {"onedispatch": f["n"]})
                if [sha256(j) for j in out] != want:
                    raise AssertionError(f"{name} {arm}: cuda JPEGs differ from the JAX goldens")
                rates[arm] = mpix / wall_ms(batch) * 1e3
        # the fused batch: one chunk of all frames (within fused_max_blocks)
        chunk = min(f["n"], fused_max_blocks() // blocks_per_image(f["height"], f["width"],
                                                                   cfg.chroma_subsampling))
        chunks = -(-f["n"] // chunk)
        if chunk != f["n"]:
            raise AssertionError(f"{name}: the chunk bound allows {chunk} of {f['n']} frames")

        def fused():
            return port.encode_batch(frames, f["maxval"], cfg, fused_batch=f["n"], device=dev)

        torch.cuda.reset_peak_memory_stats(dev)
        out = run_path(f"{name} fused_batch={f['n']}", fused, {
            "phase1": chunks, "block_hist": 0, "scan_pack": 0, "scan_pack_slab": 0,
            "histogram": 4 * chunks, "table_lookup": 2 * chunks, "pack_emissions": chunks},
            {"pipeline_batch": chunks, "pack_batch": chunks})
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        if [sha256(j) for j in out] != want:
            raise AssertionError(f"{name} fused_batch: cuda JPEGs differ from the JAX goldens")
        rates[f"fused_batch_{f['n']}"] = mpix / wall_ms(fused) * 1e3
        rates["encode_array_loop"] = mpix / wall_ms(lambda: [
            port.encode_array(px, f["maxval"], cfg, device=dev) for px in frames]) * 1e3
        log(f"{name}: every frame == JAX golden under all four arms; fused batch peak device "
            f"memory {peak:.3f} GiB; throughput Mpix/s "
            + ", ".join(f"{k} {v:.1f}" for k, v in rates.items()) + f" on {gpu}")

    if load_native() is None:
        raise AssertionError("native helpers did not build (cc); the 4K CLI runs need them")
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = Path(tmp) / "in.ppm", Path(tmp) / "out.jpg"
        write_ppm(src, four_k, 255)
        for flags in ([], ["--one-dispatch", "off"]):
            t0 = time.perf_counter()
            subprocess.run(
                [sys.executable, "-m", "dmmt_jpeg_encoder_tpu_torch", str(src), str(dst), "-p",
                 "P420", *flags], cwd=REPO, check=True, timeout=600,
            )
            cli_s = time.perf_counter() - t0
            if sha256(dst.read_bytes()) != goldens["4k_p420"]["jpeg_sha256"]:
                raise AssertionError(f"4K CLI {flags} output differs from the JAX golden")
            log(f"4k CLI {flags} (process start, PPM parse, build load, encode): {cli_s:.2f} s, "
                "bytes == JAX golden")

    # the phase-1 routes
    route_goldens, route_batch_goldens = load_route_goldens()
    for route, (_, variant) in ROUTES.items():
        per = {"phase1": 0, **ROUTE_LAUNCHES[route]}
        rcfgs = {name: dataclasses.replace(c, dct_variant=port.DCTVariant(variant))
                 for name, c in configs.items()}
        for label, cfgs, expect in (
            ("one-dispatch", rcfgs, {"block_hist": None, "scan_pack": None, "scan_pack_slab": 0}),
            ("one_dispatch=off", {n: dataclasses.replace(c, one_dispatch="off") for n, c in rcfgs.items()},
             {"block_hist": 2 * n_fix, "scan_pack": n_fix, "scan_pack_slab": 0}),
        ):
            expect = {**none_new, **expect, **{k: v * n_fix for k, v in per.items()}}
            with route_env(route):
                outputs = run_path(f"{route}: single-image fixtures, {label}", lambda: {
                    name: port.encode_array(images[name], f["maxval"], cfgs[name], device=dev)
                    for name, f in FIXTURES.items()
                }, expect, {"onedispatch": n_fix} if cfgs is rcfgs else two_dispatch_replays(n_fix))
            for name, jpeg in outputs.items():
                g = route_goldens[route][name]
                if sha256(jpeg) != g["jpeg_sha256"] or len(jpeg) != g["jpeg_len"]:
                    raise AssertionError(f"{name} {route} {label}: cuda JPEG differs from the JAX golden")
            log(f"{route} {label}: every fixture's cuda bytes == JAX golden")
        for name in ROUTE_BATCHES.get(route, []):
            f, frames = BATCH_FIXTURES[name], batches[name]
            cfg = dataclasses.replace(config_of(f), dct_variant=port.DCTVariant(variant))
            want = [g["jpeg_sha256"] for g in route_batch_goldens[route][name]]
            with route_env(route):
                depth = slab_depth(frames, cfg)
                groups = -(-f["n"] // depth)
                for label, fb, expect in (
                    (f"slab (depth {depth})", 0,
                     {"block_hist": 2 * f["n"], "scan_pack": f["n"], "scan_pack_slab": 0,
                      **{k: v * groups for k, v in per.items()}}),
                    (f"fused_batch={f['n']}", f["n"],
                     {"block_hist": 0, "scan_pack": 0, "scan_pack_slab": 0, "histogram": 4,
                      "table_lookup": 2, "pack_emissions": 1, **per}),
                ):
                    out = run_path(f"{route}: {name} {label}", lambda: port.encode_batch(
                        frames, f["maxval"], cfg, fused_batch=fb, device=dev), {**none_new, **expect},
                        {"pipeline_batch": 1, "pack_batch": 1} if fb else {"onedispatch_slab": groups})
                    if [sha256(j) for j in out] != want:
                        raise AssertionError(f"{name} {route} {label}: cuda JPEGs differ from the JAX goldens")
                    log(f"{route}: {name} {label}: every frame == JAX golden")

    # DMMT_P1_PREC=high is not read by the variants: SIMPLE keeps its bytes
    # and its unsplit kernel
    simple = {name: dataclasses.replace(c, dct_variant=port.DCTVariant.SIMPLE)
              for name, c in configs.items()}
    with route_env("dct_simple"), scoped_env({"DMMT_P1_PREC": "high"}):
        outputs = run_path("dct_simple under DMMT_P1_PREC=high: single-image fixtures", lambda: {
            name: port.encode_array(images[name], f["maxval"], simple[name], device=dev)
            for name, f in FIXTURES.items()
        }, {**none_new, "phase1": 0, "plane_dct_mm": 2 * n_fix, "block_hist": None, "scan_pack": None,
            "scan_pack_slab": 0})
    for name, jpeg in outputs.items():
        if sha256(jpeg) != route_goldens["dct_simple"][name]["jpeg_sha256"]:
            raise AssertionError(f"{name} dct_simple under DMMT_P1_PREC=high: cuda JPEG differs from "
                                 "the JAX golden")
    log("dct_simple under DMMT_P1_PREC=high: every fixture's cuda bytes == the JAX golden")

    # --- 4b. channel-planar input, start_one_dispatch_multi, the decoder ----
    def jpegs_of(states, cfg, shape):
        """Finish states in the JAX package's call form -> JPEG bytes."""
        lq, cq = quantization_table_pair(cfg.quantization_preset, cfg.quality)
        for state in states:
            onedispatch.prefetch_one_dispatch(state, cfg)
        return [jpeg_bytes(shape, cfg, lq, cq, *onedispatch.finish_one_dispatch(state, cfg))
                for state in states]

    def check_frames(label, jpegs, want):
        if [sha256(j) for j in jpegs] != [g["jpeg_sha256"] for g in want]:
            raise AssertionError(f"{label}: cuda JPEGs differ from the JAX goldens")
        log(f"{label}: every JPEG == JAX golden ({len(jpegs)})")

    def per_image(counts: dict, n: int) -> dict:
        return {**none_new, "phase1": 0, "block_hist": 2 * n, "scan_pack": n, "scan_pack_slab": 0,
                **{k: v * n for k, v in counts.items()}}

    for name in ("4k_p420", "7x17_p444"):
        f, px = FIXTURES[name], images[name]
        cfg = configs[name]
        lq, cq = quantization_table_pair(cfg.quantization_preset, cfg.quality)
        planar = np.ascontiguousarray(px.transpose(2, 0, 1))
        for route, counts in ((None, {"phase1": 1}), ("p1_fused1", ROUTE_LAUNCHES["p1_fused1"]),
                              ("p1_fused1_high", ROUTE_LAUNCHES["p1_fused1_high"])):
            want = goldens[name] if route is None else route_goldens[route][name]
            for layout, pixels in (("planar host array", planar),
                                   ("planar tensor on the card", torch.from_numpy(planar).to(dev))):
                label = f"{name} start_one_dispatch, {layout}, route {route or 'default'}"
                with route_env(route):
                    jpegs = run_path(label, lambda: jpegs_of([onedispatch.start_one_dispatch(
                        pixels, f["maxval"], cfg, lq, cq, device=dev)], cfg, px.shape[:2]),
                        per_image(counts, 1), {"onedispatch": 1})
                check_frames(label, jpegs, [want])
    for name in ("batch_odd_p422", "batch_1080p_p420"):
        f, frames = BATCH_FIXTURES[name], batches[name]
        cfg = config_of(f)
        lq, cq = quantization_table_pair(cfg.quantization_preset, cfg.quality)
        stack = np.ascontiguousarray(np.stack(frames).transpose(0, 3, 1, 2))
        label = f"{name} start_one_dispatch_slab, planar host stack [B, 3, H, W]"
        jpegs = run_path(label, lambda: jpegs_of(onedispatch.start_one_dispatch_slab(
            stack, f["maxval"], cfg, lq, cq, device=dev), cfg, frames[0].shape[:2]),
            {**per_image({}, f["n"]), "phase1": 1}, {"onedispatch_slab": 1})
        check_frames(label, jpegs, batch_goldens[name])

    fm, frames_m = BATCH_FIXTURES["batch_1080p_p420"], batches["batch_1080p_p420"][:4]
    cfg_m, shape_m = config_of(fm), frames_m[0].shape[:2]
    lq_m, cq_m = quantization_table_pair(cfg_m.quantization_preset, cfg_m.quality)
    stack_m = np.stack(frames_m)
    for layout, pixels in (("[B, H, W, 3]", stack_m),
                           ("planar [B, 3, H, W]", np.ascontiguousarray(stack_m.transpose(0, 3, 1, 2)))):
        label = f"batch_1080p_p420 x 4 start_one_dispatch_multi, host {layout}"
        jpegs = run_path(label, lambda: jpegs_of(onedispatch.start_one_dispatch_multi(
            pixels, fm["maxval"], cfg_m, lq_m, cq_m, device=dev), cfg_m, shape_m),
            per_image({"phase1": 1}, 4), {"onedispatch_multi": 1})
        check_frames(label, jpegs, batch_goldens["batch_1080p_p420"][:4])

    def multi_scans():
        states = onedispatch.start_one_dispatch_multi(stack_m, fm["maxval"], cfg_m, lq_m, cq_m, device=dev)
        for state in states:
            onedispatch.prefetch_one_dispatch(state)
        return [onedispatch.finish_one_dispatch(state) for state in states]

    def single_scans():
        return [onedispatch.finish_one_dispatch(onedispatch.start_one_dispatch(
            px, fm["maxval"], cfg_m, lq_m, cq_m, device=dev)) for px in frames_m]

    if multi_scans() != single_scans():
        raise AssertionError("start_one_dispatch_multi: scans differ from single starts")
    rounds = {"multi": [], "singles": []}
    for order in (("multi", "singles"), ("singles", "multi")) * 5:
        for arm in order:
            t0 = time.perf_counter()
            (multi_scans if arm == "multi" else single_scans)()
            rounds[arm].append((time.perf_counter() - t0) * 1e3)
    log("batch_1080p_p420 x 4, host frames -> scan bytes + tables, 10 alternating rounds, median "
        f"(min-max) ms: start_one_dispatch_multi + finishes "
        f"{statistics.median(rounds['multi']):.3f} ({min(rounds['multi']):.3f}-{max(rounds['multi']):.3f}), "
        f"a loop of start_one_dispatch + finish {statistics.median(rounds['singles']):.3f} "
        f"({min(rounds['singles']):.3f}-{max(rounds['singles']):.3f}) on {gpu}")

    t0 = time.perf_counter()
    jpeg4k = port.encode_array(four_k, 255, cfg4, device=dev)
    check_golden("4k_p420", jpeg4k, "encode_array for the decoder")
    decoded = decode_jpeg(jpeg4k)
    value = psnr(decoded, four_k)
    log(f"4k_p420 decoded by debug.jpeg_decoder (numpy, on the host): {decoded.shape}, PSNR "
        f"{value!r} dB against the source pixels (floor {DECODE_PSNR_FLOOR_4K}), "
        f"{time.perf_counter() - t0:.1f} s")
    if decoded.shape != four_k.shape or not value >= DECODE_PSNR_FLOOR_4K:
        raise AssertionError(f"4k_p420 decode: PSNR {value} dB below the floor {DECODE_PSNR_FLOOR_4K}")

    # --- 4c. the one-dispatch programs (CUDA graphs) -------------------------
    # every start is one replay of a captured program; its JPEG must equal
    # the eager enqueue's (onedispatch._enqueue: what the program captures,
    # run op by op) and the golden
    t_phase = time.perf_counter()

    def eager_jpegs(pixels, maxval, cfg, shape, group=None, onepack=False):
        """The eager enqueue's JPEGs: one image, or a slab ("slab") or multi
        ("multi") group."""
        lq, cq = quantization_table_pair(cfg.quantization_preset, cfg.quality)
        if group == "slab":
            rgb = row_stack(pixels, maxval, cfg.chroma_subsampling, dev)
            states = onedispatch._enqueue(rgb, int(pixels.shape[0]), maxval, cfg, lq, cq, onepack)
        else:
            planar = image_layout(pixels.shape[1:] if group else pixels.shape)[0]
            rgbs = interleaved(as_device(pixels, maxval, dev), planar)
            states = [s for rgb in (rgbs.unbind(0) if group else [rgbs])
                      for s in onedispatch._enqueue(rgb, 1, maxval, cfg, lq, cq, False)]
        return jpegs_of(states, cfg, shape)

    def check_replay(label, graph, eager, want):
        if graph != eager:
            raise AssertionError(f"{label}: the replayed JPEGs differ from the eager enqueue's")
        if [sha256(j) for j in graph] != want:
            raise AssertionError(f"{label}: the replayed JPEGs differ from the JAX goldens")

    n_replayed = 0
    for route in (None, *ROUTES):
        variant = "arai" if route is None else ROUTES[route][1]
        per = {"phase1": 1} if route is None else ROUTE_LAUNCHES[route]
        for name, f in FIXTURES.items():
            px = images[name]
            cfg = dataclasses.replace(configs[name], dct_variant=port.DCTVariant(variant))
            lq, cq = quantization_table_pair(cfg.quantization_preset, cfg.quality)
            want = (goldens[name] if route is None else route_goldens[route][name])["jpeg_sha256"]
            label = f"{name} start_one_dispatch replay, route {route or 'default'}"
            with route_env(route):
                graph = run_path(label, lambda: jpegs_of([onedispatch.start_one_dispatch(
                    px, f["maxval"], cfg, lq, cq, device=dev)], cfg, px.shape[:2]),
                    per_image(per, 1), {"onedispatch": 1})
                check_replay(label, graph, eager_jpegs(px, f["maxval"], cfg, px.shape[:2]), [want])
            n_replayed += 1
    name, f = "333x1001_p422", FIXTURES["333x1001_p422"]
    px, cfg = images[name], configs[name]
    lq, cq = quantization_table_pair(cfg.quantization_preset, cfg.quality)
    for hist in ("matmul", "pallas"):
        label = f"{name} start_one_dispatch replay, DMMT_HIST={hist}"
        with scoped_env({"DMMT_HIST": hist}):
            graph = run_path(label, lambda: jpegs_of([onedispatch.start_one_dispatch(
                px, f["maxval"], cfg, lq, cq, device=dev)], cfg, px.shape[:2]),
                {**per_image({"phase1": 1}, 1), "block_hist": 0, "histogram": 4}, {"onedispatch": 1})
            check_replay(label, graph, eager_jpegs(px, f["maxval"], cfg, px.shape[:2]),
                         [goldens[name]["jpeg_sha256"]])
        n_replayed += 1
    for name in ("4k_p420", "7x17_p444"):
        f, px, cfg = FIXTURES[name], images[name], configs[name]
        lq, cq = quantization_table_pair(cfg.quantization_preset, cfg.quality)
        planar = np.ascontiguousarray(px.transpose(2, 0, 1))
        for layout, pixels in (("planar host array", planar),
                               ("planar tensor on the card", torch.from_numpy(planar).to(dev))):
            label = f"{name} start_one_dispatch replay, {layout}"
            graph = run_path(label, lambda: jpegs_of([onedispatch.start_one_dispatch(
                pixels, f["maxval"], cfg, lq, cq, device=dev)], cfg, px.shape[:2]),
                per_image({"phase1": 1}, 1), {"onedispatch": 1})
            check_replay(label, graph, eager_jpegs(pixels, f["maxval"], cfg, px.shape[:2]),
                         [goldens[name]["jpeg_sha256"]])
            n_replayed += 1
    for name in ("batch_odd_p422", "batch_1080p_p420"):
        f, frames = BATCH_FIXTURES[name], batches[name]
        cfg = config_of(f)
        lq, cq = quantization_table_pair(cfg.quantization_preset, cfg.quality)
        stack, n = np.stack(frames), f["n"]
        for onepack in ("0", "1"):
            label = f"{name} start_one_dispatch_slab replay, DMMT_SLAB_ONEPACK={onepack}"
            with scoped_env({"DMMT_SLAB_ONEPACK": onepack}):
                graph = run_path(label, lambda: jpegs_of(onedispatch.start_one_dispatch_slab(
                    stack, f["maxval"], cfg, lq, cq, device=dev), cfg, frames[0].shape[:2]),
                    {**per_image({}, n), "phase1": 1, "scan_pack": n * (onepack == "0"),
                     "scan_pack_slab": int(onepack == "1")}, {"onedispatch_slab": 1})
                check_replay(label, graph, eager_jpegs(stack, f["maxval"], cfg, frames[0].shape[:2],
                                                       "slab", onepack == "1"),
                             [g["jpeg_sha256"] for g in batch_goldens[name]])
            n_replayed += 1
    for layout, pixels in (("[B, H, W, 3]", stack_m),
                           ("planar [B, 3, H, W]", np.ascontiguousarray(stack_m.transpose(0, 3, 1, 2)))):
        label = f"batch_1080p_p420 x 4 start_one_dispatch_multi replay, host {layout}"
        graph = run_path(label, lambda: jpegs_of(onedispatch.start_one_dispatch_multi(
            pixels, fm["maxval"], cfg_m, lq_m, cq_m, device=dev), cfg_m, shape_m),
            per_image({"phase1": 1}, 4), {"onedispatch_multi": 1})
        check_replay(label, graph, eager_jpegs(pixels, fm["maxval"], cfg_m, shape_m, "multi"),
                     [g["jpeg_sha256"] for g in batch_goldens["batch_1080p_p420"][:4]])
        n_replayed += 1
    log(f"one-dispatch programs: {n_replayed} replayed starts (every fixture under every route, "
        "DMMT_HIST=matmul and pallas, planar input, both slab pack arms, multi groups) == the "
        "eager enqueue's JPEGs == the JAX goldens, one replay each")

    # 8 starts in flight on 8 different frames, finished in reverse order:
    # each keeps its own words, tables and bits
    lq4, cq4 = quantization_table_pair(cfg4.quantization_preset, cfg4.quality)
    dpx = torch.from_numpy(four_k).to(dev)
    rolled = [np.roll(four_k, 17 * i, axis=1) for i in range(8)]
    refs = [port.encode_array(fr, 255, off["4k_p420"], device=dev) for fr in rolled]
    if len(set(refs)) != 8 or refs[0] != jpeg4k:
        raise AssertionError("the 8 rolled 4K frames' two-dispatch JPEGs are not 8 distinct ones")
    dev_frames = [torch.from_numpy(fr).to(dev) for fr in rolled]

    def in_flight():
        states = [onedispatch.start_one_dispatch(fr, 255, cfg4, lq4, cq4) for fr in dev_frames]
        return jpegs_of(states[::-1], cfg4, four_k.shape[:2])[::-1]

    if run_path("4k_p420 x 8 rolled frames, 8 starts in flight, finished in reverse", in_flight,
                per_image({"phase1": 1}, 8), {"onedispatch": 8}) != refs:
        raise AssertionError("8 starts in flight: a JPEG differs from its frame's two-dispatch bytes")
    log("4k_p420 x 8 rolled frames in flight, finished in reverse order: each JPEG == its "
        "frame's two-dispatch bytes")

    # a mode toggled after the first capture at a geometry takes effect
    onedispatch._compiled_onedispatch.cache_clear()
    for route, want in ((None, goldens["4k_p420"]), ("p1_fused1", route_goldens["p1_fused1"]["4k_p420"]),
                        (None, goldens["4k_p420"])):
        label = f"4k_p420 start_one_dispatch, DMMT_P1 {ROUTES[route][0] if route else 'unset'}"
        with route_env(route):
            jpeg = run_path(label, lambda: jpegs_of([onedispatch.start_one_dispatch(
                four_k, 255, cfg4, lq4, cq4, device=dev)], cfg4, four_k.shape[:2]),
                per_image(ROUTE_LAUNCHES[route] if route else {"phase1": 1}, 1), {"onedispatch": 1})
        if sha256(jpeg[0]) != want["jpeg_sha256"]:
            raise AssertionError(f"{label}: the JPEG differs from its golden after the toggle")
    if onedispatch._compiled_onedispatch.cache_info().currsize != 2:
        raise AssertionError(f"DMMT_P1 toggled: {onedispatch._compiled_onedispatch.cache_info()}")
    log("DMMT_P1 toggled to fused1 after the first capture at 4K, then back: the p1_fused1 "
        "golden, then the default golden again, from two cache entries")

    # before (the eager enqueue, op by op) against after (one replay), in
    # alternating rounds: the host time of one start on pixels already on
    # the card; the program floor (8 starts in flight, one read of the last
    # bit count, per image); the 4K e2e (host array in, JPEG bytes out)
    def eager_start():
        return onedispatch._enqueue(dpx, 1, 255, cfg4, lq4, cq4, False)[0]

    def graph_start():
        return onedispatch.start_one_dispatch(dpx, 255, cfg4, lq4, cq4)

    def eager_e2e():
        state = onedispatch._enqueue(as_device(four_k, 255, dev), 1, 255, cfg4, lq4, cq4, False)[0]
        return jpeg_bytes(four_k.shape, cfg4, lq4, cq4, *onedispatch.finish_one_dispatch(state))

    def graph_e2e():
        return port.encode_array(four_k, 255, cfg4, device=dev)

    if eager_e2e() != graph_e2e() or graph_e2e() != jpeg4k:
        raise AssertionError("4K e2e: the eager enqueue's JPEG differs from encode_array's")
    samples = {k: [] for k in ("host eager", "host graph", "floor eager", "floor graph",
                               "e2e eager", "e2e graph")}
    for order in (("eager", "graph"), ("graph", "eager")) * 5:
        for arm in order:
            start = eager_start if arm == "eager" else graph_start
            for _ in range(10):
                t0 = time.perf_counter()
                state = start()
                samples[f"host {arm}"].append((time.perf_counter() - t0) * 1e3)
                state.total_bits.item()
                del state
            t0 = time.perf_counter()
            states = [start() for _ in range(8)]
            states[-1].total_bits.item()
            samples[f"floor {arm}"].append((time.perf_counter() - t0) * 1e3 / 8)
            del states
            t0 = time.perf_counter()
            (eager_e2e if arm == "eager" else graph_e2e)()
            samples[f"e2e {arm}"].append((time.perf_counter() - t0) * 1e3)
    mpix4 = four_k.shape[0] * four_k.shape[1] / 1e6
    for k, v in samples.items():
        med = statistics.median(v)
        rate = "" if k.startswith("host") else f", {mpix4 / med * 1e3:.1f} Mpix/s"
        log(f"4k_p420 {k}: median {med:.4f} ms ({min(v):.4f}-{max(v):.4f}) of {len(v)}{rate} "
            f"on {gpu}")
    pool = onedispatch._compiled_onedispatch(
        2160, 3840, cfg4.chroma_subsampling, cfg4.dct_variant, False,
        *programs.program_key(dpx, 255, lq4, cq4, dpx.device))
    log(f"4k_p420 one instance's graph pool: {max((p.bytes for p in pool.idle), default=0)} bytes, "
        f"{len(pool.idle)} instances "
        f"idle; all captured instances {programs.graph_bytes()} bytes; torch.cuda."
        f"memory_reserved {torch.cuda.memory_reserved(dev)} bytes after the phase; graph replays so "
        f"far {json.dumps(replays)}; phase {time.perf_counter() - t_phase:.1f} s")

    # --- 5. the sharded encode (parallel/sharding.py) ------------------------
    # n shards on card 0 (a device list that repeats it); each path starts
    # with no card probed, so its capability probe shows in its counts
    def run_sharded(label, fn, expect, replayed):
        capability._CAPABLE.clear()
        return run_path(label, fn, expect, replayed)

    @contextlib.contextmanager
    def eager_programs():
        """Every program enqueues op by op (programs.card names no card), in
        place of a replay: the sharded starts as across distinct cards
        (sharding._start)."""
        real = programs.card
        programs.card = lambda pixels, device: None
        try:
            yield
        finally:
            programs.card = real

    def check_eager(label, graph, eager):
        if graph != eager:
            raise AssertionError(f"{label}: the replayed JPEGs differ from the eager enqueue's")

    def on_card(n):
        return [f"cuda:{dev.index or 0}"] * n

    def sharded_cfg(cfg, n, **kw):
        return dataclasses.replace(cfg, num_shards=n, **kw)

    # one_dispatch="off" is not read on the sharded path (as in the JAX
    # package); the two-dispatch arm with the scan-pack kernel runs for
    # images past the device table build's bound, here lowered to 1 symbol
    two_dispatch_runs = []
    real_finish = sharding._finish_twodispatch

    def counted_finish(state):
        two_dispatch_runs.append(1)
        return real_finish(state)

    sharding._finish_twodispatch = counted_finish
    for n in (2, 8):
        for label, kw, table_bound, two in (
            ("one-dispatch", {}, onedispatch.MAX_DEVICE_TABLE_SYMBOLS, 0),
            ('one_dispatch="off" (not read: one dispatch)', {"one_dispatch": "off"},
             onedispatch.MAX_DEVICE_TABLE_SYMBOLS, 0),
            ("past a table bound of 1 symbol (two dispatches, scan-pack arm)", {}, 1, n_fix),
        ):
            saved_bound, onedispatch.MAX_DEVICE_TABLE_SYMBOLS = onedispatch.MAX_DEVICE_TABLE_SYMBOLS, table_bound
            two_dispatch_runs.clear()
            def fixtures_at(n=n, kw=kw):
                return {name: port.encode_array(images[name], f["maxval"],
                                                sharded_cfg(configs[name], n, **kw), device=on_card(n))
                        for name, f in FIXTURES.items()}

            try:
                outputs = run_sharded(f"sharded n={n} on one card, single-image fixtures, {label}",
                                      fixtures_at, sharded_launches(n, 1, 1, times=n_fix),
                                      {"sharded": n_fix, "shard_pack": n_fix} if two
                                      else {"sharded_onedispatch": n_fix})
                if len(two_dispatch_runs) != two:
                    raise AssertionError(f"sharded n={n} {label}: {len(two_dispatch_runs)} "
                                         f"two-dispatch encodes, expected {two}")
                with eager_programs():
                    check_eager(f"sharded n={n} {label}", outputs, fixtures_at())
            finally:
                onedispatch.MAX_DEVICE_TABLE_SYMBOLS = saved_bound
            for name, jpeg in outputs.items():
                check_golden(name, jpeg, f"sharded n={n} {label}")
    sharding._finish_twodispatch = real_finish
    simple_golden = route_goldens["dct_simple"]["4k_p420"]["jpeg_sha256"]
    for n in (2, 4):
        for label, env, kw, expect, want, replayed in (
            ("staged pack (DMMT_NO_FUSED_PACK=1)", {"DMMT_NO_FUSED_PACK": "1"}, {},
             sharded_launches(n, 1, 1, pack="staged"), None, {"sharded": 1, "shard_pack": 1}),
            ("DMMT_HIST=pallas", {"DMMT_HIST": "pallas"}, {}, sharded_launches(n, 1, 1, hist="pallas"),
             None, {"sharded_onedispatch": 1}),
            ("host scan backend", {}, {"scan_backend": "host"}, sharded_launches(n, 1, 1, pack="host"),
             None, {"sharded": 1}),
            ("DMMT_P1=mxu, DMMT_P1_PREC=high (ignored: the default bytes)",
             {"DMMT_P1": "mxu", "DMMT_P1_PREC": "high"}, {},
             sharded_launches(n, 1, 1), None, {"sharded_onedispatch": 1}),
            ("FUSED (the Arai phase 1: the default bytes)", {}, {"dct_variant": port.DCTVariant.FUSED},
             sharded_launches(n, 1, 1), None, {"sharded_onedispatch": 1}),
            ("SIMPLE", {}, {"dct_variant": port.DCTVariant.SIMPLE},
             sharded_launches(n, 1, 1, p1=("plane_dct_mm", 2)), simple_golden,
             {"sharded_onedispatch": 1}),
        ):
            def encode_4k(n=n, kw=kw):
                return port.encode_array(four_k, 255, sharded_cfg(cfg4, n, **kw), device=on_card(n))

            with scoped_env(env):
                jpeg = run_sharded(f"4k_p420 sharded n={n} on one card, {label}", encode_4k, expect,
                                   replayed)
                with eager_programs():
                    check_eager(f"4k_p420 sharded n={n} {label}", jpeg, encode_4k())
            if want is None:
                check_golden("4k_p420", jpeg, f"sharded n={n} {label}")
            elif sha256(jpeg) != want:
                raise AssertionError(f"4k_p420 sharded n={n} {label}: cuda JPEG differs from the JAX golden")
            else:
                log(f"4k_p420 sharded n={n} {label}: cuda bytes == JAX golden")

    fb, frames_b = BATCH_FIXTURES["batch_1080p_p420"], batches["batch_1080p_p420"]
    want = [g["jpeg_sha256"] for g in batch_goldens["batch_1080p_p420"]]
    cfg_b = sharded_cfg(config_of(fb), 2)
    depth = slab_depth(frames_b, cfg_b, sharding.shard_devices(on_card(2), 2))
    groups = -(-fb["n"] // depth)
    if depth < 2:
        raise AssertionError(f"batch_1080p_p420 sharded: the gate chose depth {depth}")
    # the slab groups of `depth` and a trailing single image: one replay each
    sizes = [min(depth, fb["n"] - i) for i in range(0, fb["n"], depth)]
    slab_replays = {"sharded_onedispatch_slab": sum(k > 1 for k in sizes),
                    "sharded_onedispatch": sum(k == 1 for k in sizes)}

    def sharded_batch():
        return port.encode_batch(frames_b, fb["maxval"], cfg_b, device=on_card(2))

    for arm, env, expect, replayed in (
        (f"sharded slab (depth {depth})", {"DMMT_SLAB_ONEPACK": "0"},
         sharded_launches(2, fb["n"], groups), slab_replays),
        (f"sharded slab one-pack (depth {depth})", {"DMMT_SLAB_ONEPACK": "1"},
         sharded_launches(2, fb["n"], groups, pack="slab"), slab_replays),
        ("sharded per image (DMMT_SLAB=0)", {"DMMT_SLAB": "0"}, sharded_launches(2, fb["n"], fb["n"]),
         {"sharded_onedispatch": fb["n"]}),
    ):
        with scoped_env(env):
            out = run_sharded(f"batch_1080p_p420 n=2 on one card, {arm}", sharded_batch, expect,
                              {k: v for k, v in replayed.items() if v})
            with eager_programs():
                check_eager(f"batch_1080p_p420 n=2 {arm}", out, sharded_batch())
        if [sha256(j) for j in out] != want:
            raise AssertionError(f"batch_1080p_p420 n=2 {arm}: cuda JPEGs differ from the JAX goldens")
        log(f"batch_1080p_p420 n=2 {arm}: every frame == JAX golden")

    with tempfile.TemporaryDirectory() as tmp:
        src, dst = Path(tmp) / "in.ppm", Path(tmp) / "out.jpg"
        write_ppm(src, four_k, 255)
        cli = [sys.executable, "-m", "dmmt_jpeg_encoder_tpu_torch", str(src), str(dst), "-p", "P420",
               "--shards", "2"]
        subprocess.run([*cli, "--device", ",".join(on_card(2))], cwd=REPO, check=True, timeout=600)
        if sha256(dst.read_bytes()) != goldens["4k_p420"]["jpeg_sha256"]:
            raise AssertionError("4K CLI --shards 2 output differs from the JAX golden")
        dst.unlink()
        rc = subprocess.run(cli, cwd=REPO, timeout=600, capture_output=True, text=True)
        if torch.cuda.device_count() < 2 and (rc.returncode != 1 or dst.exists()):
            raise AssertionError(f"CLI --shards 2 on {torch.cuda.device_count()} card(s) gave exit "
                                 f"code {rc.returncode}, not 1: {rc.stderr}")
        if torch.cuda.device_count() >= 2 and sha256(dst.read_bytes()) != goldens["4k_p420"]["jpeg_sha256"]:
            raise AssertionError("4K CLI --shards 2 across two cards differs from the JAX golden")
        log(f"4k CLI --shards 2 --device {','.join(on_card(2))}: bytes == JAX golden; --shards 2 on "
            f"{torch.cuda.device_count()} card(s) with --device cuda: exit code {rc.returncode} "
            f"({rc.stderr.strip()})")

    for n in (2, 4, 8):
        if torch.cuda.device_count() < n:
            log(f"sharded n={n} across distinct cards: not run ({torch.cuda.device_count()} card(s))")
            continue
        jpeg = run_sharded(f"4k_p420 sharded n={n} across {n} cards", lambda: port.encode_array(
            four_k, 255, sharded_cfg(cfg4, n), device="cuda"), sharded_launches(n, 1, 1, probes=n), {})
        check_golden("4k_p420", jpeg, f"sharded n={n} across {n} cards")

    # the multi-process encode: two gloo processes on card 0
    with tempfile.TemporaryDirectory() as tmp, socket.socket() as s:
        s.bind(("localhost", 0))
        free_port = s.getsockname()[1]
        s.close()
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, "-c", DISTRIBUTED_WORKER, str(rank), str(free_port),
                                   f"{tmp}/jpeg", str(REPO), json.dumps(DISTRIBUTED_CASES)],
                                  cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for rank in range(2)]
        try:
            results = [p.communicate(timeout=600) for p in procs]
        finally:
            for p in procs:
                p.kill()
        for rank, (p, (out, err)) in enumerate(zip(procs, results)):
            if p.returncode != 0:
                raise AssertionError(f"distributed rank {rank} exited {p.returncode}:\n{err[-4000:]}")
            counts = json.loads(out.strip().splitlines()[-1])
            log(f"distributed rank {rank} launches: {counts}")
            for k in ("phase1", "block_hist", "scan_pack", "probe"):
                if counts[k] == 0:
                    raise AssertionError(f"distributed rank {rank}: {k} never launched")
        for name, n in DISTRIBUTED_CASES:
            check_golden(name, Path(f"{tmp}/jpeg.{name}.{n}").read_bytes(),
                         f"encode_array_distributed, 2 gloo processes, n={n}")
        log(f"distributed: {len(DISTRIBUTED_CASES)} encodes in 2 processes, "
            f"{time.perf_counter() - t0:.1f} s with process start")

    mpix = FIXTURES["4k_p420"]["height"] * FIXTURES["4k_p420"]["width"] / 1e6
    for route, (_, variant) in ROUTES.items():
        cfg = dataclasses.replace(cfg4, dct_variant=port.DCTVariant(variant))
        with route_env(route):
            times = []
            for _ in range(6):
                t0 = time.perf_counter()
                port.encode_array(four_k, 255, cfg, device=dev)
                times.append((time.perf_counter() - t0) * 1e3)
        e2e_ms = statistics.median(times[1:])
        log(f"4k e2e encode_array one-dispatch, route {route}: median {e2e_ms:.3f} ms of 5, "
            f"{mpix / e2e_ms * 1e3:.1f} Mpix/s on {gpu}")
    for label, cfg, reps in (("one-dispatch", cfg4, 10), ("two-dispatch (one_dispatch=off)",
                                                          off["4k_p420"], 10),
                             ("two-dispatch, host scan backend", host4, 3)):
        times = []
        for _ in range(reps + 1):
            t0 = time.perf_counter()
            port.encode_array(four_k, 255, cfg, device=dev)
            times.append((time.perf_counter() - t0) * 1e3)
        e2e_ms = statistics.median(times[1:])
        log(f"4k e2e encode_array {label} (host array in, JPEG bytes out): median {e2e_ms:.3f} ms "
            f"of {reps}, {mpix / e2e_ms * 1e3:.1f} Mpix/s on {gpu}")
    # what sharding costs on one card (not scaling: every shard runs on card 0)
    for n in (1, 2, 4, 1):
        e2e_ms = wall_ms(lambda: port.encode_array(four_k, 255, sharded_cfg(cfg4, n),
                                                   device=on_card(n) if n > 1 else dev), reps=5)
        log(f"4k e2e encode_array one-dispatch, num_shards={n} on one card: median {e2e_ms:.3f} ms "
            f"of 5, {mpix / e2e_ms * 1e3:.1f} Mpix/s on {gpu}")
    mpix_b = fb["n"] * fb["height"] * fb["width"] / 1e6
    for label, cfg, device in (("slab, one shard", config_of(fb), dev),
                               ("sharded slab, num_shards=2 on one card", cfg_b, on_card(2)),
                               ("slab, one shard", config_of(fb), dev)):
        batch_ms = wall_ms(lambda: port.encode_batch(frames_b, fb["maxval"], cfg, device=device))
        log(f"batch_1080p_p420 encode_batch {label}: median {batch_ms:.3f} ms of 3, "
            f"{mpix_b / batch_ms * 1e3:.1f} Mpix/s on {gpu}")
    # the sharded programs (CUDA graphs, parallel/sharding.py): two starts in
    # flight on two rolled 4K frames, finished in reverse order, each
    # against its frame's two-dispatch bytes; then DMMT_HIST=pallas toggled
    # after the first capture and back
    cfg2 = sharded_cfg(cfg4, 2)

    def sharded_in_flight():
        states = [sharding.start_sharded_encode(fr, 255, cfg2, on_card(2)) for fr in rolled[:2]]
        return [jpeg_bytes(four_k.shape, cfg2, lq4, cq4, *sharding.finish_sharded_encode(st, cfg2))
                for st in states[::-1]][::-1]

    if run_sharded("4k_p420 x 2 rolled frames, 2 sharded starts (n=2) in flight, finished in reverse",
                   sharded_in_flight, sharded_launches(2, 1, 1, times=2),
                   {"sharded_onedispatch": 2}) != refs[:2]:
        raise AssertionError("2 sharded starts in flight: a JPEG differs from its frame's "
                             "two-dispatch bytes")
    log("4k_p420 x 2 rolled frames, 2 sharded starts (n=2) in flight, finished in reverse order: "
        "each JPEG == its frame's two-dispatch bytes")
    sharding._compiled_sharded_onedispatch.cache_clear()
    for hist, expect in ((None, sharded_launches(2, 1, 1)),
                         ("pallas", sharded_launches(2, 1, 1, hist="pallas")),
                         (None, sharded_launches(2, 1, 1))):
        label = f"4k_p420 sharded n=2, DMMT_HIST {hist or 'unset'}"
        with scoped_env({"DMMT_HIST": hist} if hist else {}):
            jpeg = run_sharded(label, lambda: port.encode_array(four_k, 255, cfg2, device=on_card(2)),
                               expect, {"sharded_onedispatch": 1})
        check_golden("4k_p420", jpeg, label)
    if sharding._compiled_sharded_onedispatch.cache_info().currsize != 2:
        raise AssertionError(f"DMMT_HIST toggled: {sharding._compiled_sharded_onedispatch.cache_info()}")
    log("DMMT_HIST toggled to pallas after the first sharded capture at 4K, then back: the weighted "
        "histograms' counts, then the block histograms' again, from two cache entries")

    # before (the eager enqueue, op by op) against after (one replay), in
    # alternating rounds at n = 2 and 4 on one card: one sharded start's
    # host time (host array in, small copy enqueued); the program floor (8
    # starts in flight on pixels already on the card, one wait for the last
    # small copy, per image); the 4K e2e; the 16 x 1080p sharded slab
    for n in (2, 4):
        cfg_n, devs = sharded_cfg(cfg4, n), sharding.shard_devices(on_card(n), n)
        cfg_bn = sharded_cfg(config_of(fb), n)
        geom = sharding.Geometry.of(*four_k.shape[:2], cfg4.chroma_subsampling, n)
        padded = torch.zeros((geom.ph, geom.pw, 3), dtype=torch.uint8, device=dev)
        padded[: four_k.shape[0], : four_k.shape[1]] = dpx
        pool = sharding._compiled_sharded_onedispatch(
            *four_k.shape[:2], cfg4.chroma_subsampling, cfg4.dct_variant, n,
            *programs.program_key(four_k, 255, lq4, cq4, devs[0]))

        def arm_ctx(arm):
            return eager_programs() if arm == "eager" else contextlib.nullcontext()

        def start(arm):
            with arm_ctx(arm):
                return sharding.start_sharded_encode(four_k, 255, cfg_n, devs)

        def floor_start(arm):
            if arm == "graph":
                return sharding._replay(pool, dpx, 255)
            state = sharding._enqueue(sharding.shard_slabs(padded, geom), 1, 255, cfg_n, lq4, cq4,
                                      geom, devs, True)
            sharding._prefetch(state)
            return state

        def e2e(arm):
            with arm_ctx(arm):
                return port.encode_array(four_k, 255, cfg_n, device=devs)

        def batch(arm):
            with arm_ctx(arm):
                return port.encode_batch(frames_b, fb["maxval"], cfg_bn, device=devs)

        floor_jpegs = {}
        for arm in ("eager", "graph"):
            if e2e(arm) != jpeg4k or [sha256(j) for j in batch(arm)] != want:
                raise AssertionError(f"sharded n={n} {arm}: a JPEG differs from the JAX golden")
            st = floor_start(arm)
            floor_jpegs[arm] = jpeg_bytes(four_k.shape, cfg_n, lq4, cq4,
                                          *sharding.finish_sharded_encode(st, cfg_n))
        if floor_jpegs != {"eager": jpeg4k, "graph": jpeg4k}:
            raise AssertionError(f"sharded n={n}: a floor start's JPEG differs from the golden")
        for arm in ("eager", "graph"):  # the 8 instances in flight captured before the rounds
            states = [floor_start(arm) for _ in range(8)]
            states[-1].small_ready.synchronize()
            del states
        samples = {f"{what} {arm}": [] for what in ("host", "floor", "e2e", "batch")
                   for arm in ("eager", "graph")}
        for order in (("eager", "graph"), ("graph", "eager")) * 5:
            for arm in order:
                for _ in range(10):
                    t0 = time.perf_counter()
                    st = start(arm)
                    samples[f"host {arm}"].append((time.perf_counter() - t0) * 1e3)
                    sharding.finish_sharded_encode(st, cfg_n)
                t0 = time.perf_counter()
                states = [floor_start(arm) for _ in range(8)]
                states[-1].small_ready.synchronize()
                samples[f"floor {arm}"].append((time.perf_counter() - t0) * 1e3 / 8)
                del states, st
                t0 = time.perf_counter()
                e2e(arm)
                samples[f"e2e {arm}"].append((time.perf_counter() - t0) * 1e3)
                t0 = time.perf_counter()
                batch(arm)
                samples[f"batch {arm}"].append((time.perf_counter() - t0) * 1e3)
        for k, v in samples.items():
            med = statistics.median(v)
            what = "batch_1080p_p420 (16 frames)" if k.startswith("batch") else "4k_p420"
            mp = mpix_b if k.startswith("batch") else mpix
            rate = "" if k.startswith("host") else f", {mp / med * 1e3:.1f} Mpix/s"
            log(f"{what} sharded n={n} on one card, {k}: median {med:.4f} ms "
                f"({min(v):.4f}-{max(v):.4f}) of {len(v)}{rate} on {gpu}")
        slab_pool = [p for p in programs.POOLS if p.idle and p.idle[0].kind == "sharded_onedispatch_slab"]
        log(f"4k_p420 sharded n={n}: one instance's graph pool "
            f"{max((p.bytes for p in pool.idle), default=0)} bytes, {len(pool.idle)} instances idle; "
            f"sharded slab instances {sorted(p.idle[0].bytes for p in slab_pool)} bytes")
    log(f"all captured instances {programs.graph_bytes()} bytes; torch.cuda.memory_reserved "
        f"{torch.cuda.memory_reserved(dev)} bytes after phase 5; graph replays so far "
        f"{json.dumps(replays)}")

    # --- 5b. the two-dispatch programs (CUDA graphs) -------------------------
    # each half of a two-dispatch encode on one card is one replay of a
    # captured program (pipeline._compiled_pipeline and
    # _compiled_pipeline_batch; bitstream/device_pack's _compiled_fused_pack,
    # _compiled_pack and _compiled_pack_batch; parallel/sharding's
    # _compiled_sharded and _compiled_shard_pack): every JPEG against the
    # eager enqueue's (eager_programs) and its golden
    from dmmt_jpeg_encoder_tpu_torch import pipeline
    from dmmt_jpeg_encoder_tpu_torch.bitstream import device_pack
    from dmmt_jpeg_encoder_tpu_torch.utils.device import upload

    t_phase = time.perf_counter()
    two_kinds = ("pipeline", "pipeline_batch", "fused_pack", "pack", "pack_batch", "sharded",
                 "shard_pack")

    @contextlib.contextmanager
    def lowered_bound(symbols: int):
        """The device table build's bound lowered to `symbols`: every image
        takes the two-dispatch encode."""
        saved, onedispatch.MAX_DEVICE_TABLE_SYMBOLS = onedispatch.MAX_DEVICE_TABLE_SYMBOLS, symbols
        try:
            yield
        finally:
            onedispatch.MAX_DEVICE_TABLE_SYMBOLS = saved

    def replay_against_eager(label, fn, expect, replayed, want, eager_ctx=eager_programs,
                             run=run_path):
        graph = run(label, fn, expect, replayed)
        with eager_ctx():
            eager = fn()
        graph, eager = ([x] if isinstance(x, bytes) else x for x in (graph, eager))
        check_replay(label, graph, eager, want)

    n_two = 0
    per_two = {**none_new, "phase1": 1, "block_hist": 2, "scan_pack": 1, "scan_pack_slab": 0}
    for name, f in FIXTURES.items():
        replay_against_eager(f"{name} two-dispatch (one_dispatch=off) replay",
                             lambda: port.encode_array(images[name], f["maxval"], off[name], device=dev),
                             per_two, two_dispatch_replays(1), [goldens[name]["jpeg_sha256"]])
        n_two += 1
    for label, env, cfg, expect, replayed in (
            ("two-dispatch, fused pack", {}, off["4k_p420"], per_two, two_dispatch_replays(1)),
            *four_k_two_dispatch(off["4k_p420"], host4, none_new)):
        with scoped_env(env):
            replay_against_eager(f"4k_p420 {label} replay",
                                 lambda: port.encode_array(four_k, 255, cfg, device=dev), expect,
                                 replayed, [goldens["4k_p420"]["jpeg_sha256"]])
        n_two += 1
    f16, frames16 = BATCH_FIXTURES["batch_1080p_p420"], batches["batch_1080p_p420"]
    cfg16 = config_of(f16)

    def fused16():
        return port.encode_batch(frames16, f16["maxval"], cfg16, fused_batch=f16["n"], device=dev)

    replay_against_eager(
        "batch_1080p_p420 fused_batch=16 replay", fused16,
        {**none_new, "phase1": 1, "block_hist": 0, "scan_pack": 0, "scan_pack_slab": 0,
         "histogram": 4, "table_lookup": 2, "pack_emissions": 1},
        {"pipeline_batch": 1, "pack_batch": 1}, [g["jpeg_sha256"] for g in batch_goldens["batch_1080p_p420"]])
    n_two += 1
    cfg2 = sharded_cfg(cfg4, 2)
    sharded_two = (("past a table bound of 1 symbol", {}, 1, sharded_launches(2, 1, 1)),
                   ("DMMT_NO_FUSED_PACK=1", {"DMMT_NO_FUSED_PACK": "1"},
                    onedispatch.MAX_DEVICE_TABLE_SYMBOLS, sharded_launches(2, 1, 1, pack="staged")))
    for label, env, symbols, expect in sharded_two:
        with lowered_bound(symbols), scoped_env(env):
            replay_against_eager(
                f"4k_p420 sharded two-dispatch n=2 on one card, {label}, replay",
                lambda: port.encode_array(four_k, 255, cfg2, device=on_card(2)), expect,
                {"sharded": 1, "shard_pack": 1}, [goldens["4k_p420"]["jpeg_sha256"]],
                eager_ctx=eager_programs, run=run_sharded)
        n_two += 1
    log(f"two-dispatch programs: {n_two} replayed paths (every fixture one_dispatch=off; the 4K "
        "frame with the fused pack, the staged pack, DMMT_HIST=pallas and the host scan backend; "
        "16 x 1080p fused_batch=16; the sharded two-dispatch at n=2 past a table bound and under "
        "DMMT_NO_FUSED_PACK) == the eager enqueue's JPEGs == the JAX goldens, one replay per program")

    # a state finished twice, a start of another image replaying its
    # instance between the finishes: the first finish's bytes and tables
    name = "333x1001_p422"
    pa, pb = images[name], np.ascontiguousarray(images[name][::-1])
    cfga = configs[name]
    lqa, cqa = quantization_table_pair(cfga.quantization_preset, cfga.quality)
    cfga2 = sharded_cfg(cfga, 2)

    def one_finish(states):
        return [jpeg_bytes(pa.shape, cfga, lqa, cqa, *onedispatch.finish_one_dispatch(s))
                for s in states]

    def sharded_finish(states):
        (state,) = states
        done = (sharding.finish_sharded_encode_slab(state, cfga2) if state.n_images > 1
                else [sharding.finish_sharded_encode(state, cfga2)])
        return [jpeg_bytes(pa.shape, cfga2, lqa, cqa, *d) for d in done]

    refinish = {
        "start_one_dispatch": (lambda px: [onedispatch.start_one_dispatch(px, 255, cfga, lqa, cqa)],
                               one_finish, 1, None),
        "start_one_dispatch_slab": (lambda px: onedispatch.start_one_dispatch_slab(
            np.stack([px, px[:, ::-1]]), 255, cfga, lqa, cqa), one_finish, 2, None),
        "start_one_dispatch_multi": (lambda px: onedispatch.start_one_dispatch_multi(
            np.stack([px, px[:, ::-1]]), 255, cfga, lqa, cqa), one_finish, 2, None),
        "start_sharded_encode": (lambda px: [sharding.start_sharded_encode(px, 255, cfga2, on_card(2))],
                                 sharded_finish, 1, None),
        "start_sharded_encode_slab": (lambda px: [sharding.start_sharded_encode_slab(
            [px, np.ascontiguousarray(px[:, ::-1])], 255, cfga2, on_card(2))], sharded_finish, 2, None),
        "start_sharded_encode, two-dispatch": (
            lambda px: [sharding.start_sharded_encode(px, 255, cfga2, on_card(2))], sharded_finish, 1, 1),
    }
    for label, (start, finish, n, symbols) in refinish.items():
        with lowered_bound(symbols or onedispatch.MAX_DEVICE_TABLE_SYMBOLS):
            states = start(pa)
            first = finish(states)
            other = finish(start(pb))
            again = finish(states)
        if again != first or other == first:
            raise AssertionError(f"{label}: a state finished again after another start's replay "
                                 "gave other bytes than its first finish")
        if [sha256(j) for j in first[:1]] != [goldens[name]["jpeg_sha256"]]:
            raise AssertionError(f"{label}: the first finish differs from the JAX golden")
    result_a = pipeline.run_device_pipeline(pa, 255, off[name], lqa, cqa, device=dev)
    tables_a = HuffmanTables.from_histograms(result_a)
    first = port.encoder.pack_scan(result_a, tables_a, off[name])
    result_b = pipeline.run_device_pipeline(pb, 255, off[name], lqa, cqa, device=dev)
    other = port.encoder.pack_scan(result_b, HuffmanTables.from_histograms(result_b), off[name])
    if port.encoder.pack_scan(result_a, tables_a, off[name]) != first or other == first:
        raise AssertionError("pack_scan of one two-dispatch result twice, another replay between: "
                             "the bytes differ")
    del result_a, result_b
    log(f"{name}: each of {', '.join(refinish)} finished twice, a start of another image replaying "
        "its instance between the finishes: the first finish's bytes and tables again (the first "
        "== the JAX golden); pack_scan of one two-dispatch result twice, another image's replays "
        "between: the same bytes")

    # eager enqueue against replay in 10 alternating rounds: the host time of
    # each half of a 4K two-dispatch encode on pixels already on the card
    # (the first half's enqueue; the pack's table upload and enqueue, fused
    # and staged; what follows each, the histogram fetch, the host tables,
    # the word fetch and the tail, is the same in both arms), the 4K e2e
    # (fused and staged pack), 16 x 1080p fused_batch=16 and the sharded
    # two-dispatch at n=2 on one card (past a table bound, and staged)
    off4 = off["4k_p420"]
    lpm4 = cfg4.chroma_subsampling.luma_blocks_per_mcu

    def first_half(arm):
        t0 = time.perf_counter()
        result = (pipeline.device_phase(dpx, 255, off4, lq4, cq4) if arm == "eager"
                  else pipeline.run_device_pipeline(dpx, 255, off4, lq4, cq4))
        return result, (time.perf_counter() - t0) * 1e3

    def pack_half(arm, result, staged):
        tables = HuffmanTables.from_histograms(result)
        hists = (result.luma_dc_hist, result.luma_ac_hist, result.chroma_dc_hist,
                 result.chroma_ac_hist)
        known = exact_scan_bits(hists, *tables.flat())
        nl, nc = int(result.luma.shape[0]), int(result.cb.shape[0])
        n_words = (device_pack.words_capacity((known + 31) // 32 + 2) if staged
                   else (nl + 2 * nc) * 64 + 2)
        values = device_pack.pack_values([tables.flat()], [0])
        if arm == "eager":
            t0 = time.perf_counter()
            words = device_pack.pack_enqueue(result.luma[None], result.cb[None], result.cr[None],
                                             lpm4, upload(values, dev), n_words, not staged)[0]
            ms = (time.perf_counter() - t0) * 1e3
            words[:1].cpu()
            return ms
        cache = device_pack._compiled_pack if staged else device_pack._compiled_fused_pack
        pool = cache(nl, nc, lpm4, n_words, dpx.device)
        program = pool.lease()
        try:
            t0 = time.perf_counter()
            ((words, *_),) = program.run((result.luma, result.cb, result.cr, values), 0)
            ms = (time.perf_counter() - t0) * 1e3
            words[:1].cpu()
        finally:
            pool.give_back(program)
        return ms

    def arm_of(arm, ctx):
        return ctx() if arm == "eager" else contextlib.nullcontext()

    packs = {"fused": {}, "staged": {"DMMT_NO_FUSED_PACK": "1"}}
    timed = {
        **{f"e2e {p}": (lambda p=p: port.encode_array(four_k, 255, off4, device=dev), packs[p],
                        eager_programs, mpix4) for p in packs},
        "fused_batch 16 x 1080p": (fused16, {}, eager_programs,
                                   f16["n"] * f16["height"] * f16["width"] / 1e6),
        **{f"sharded n=2 {label}": (lambda: port.encode_array(four_k, 255, cfg2, device=on_card(2)),
                                    env, eager_programs, mpix4)
           for label, env, _, _ in sharded_two},
    }
    bounds_of = {f"sharded n=2 {label}": symbols for label, _, symbols, _ in sharded_two}
    two_samples = {f"{k} {arm}": [] for k in (*(f"host {p}" for p in packs),
                                              *(f"first half {p}" for p in packs),
                                              *(f"pack {p}" for p in packs), *timed)
                   for arm in ("eager", "graph")}
    for order in (("eager", "graph"), ("graph", "eager")) * 5:
        for arm in order:
            for p, env in packs.items():
                with scoped_env(env):
                    for _ in range(5):
                        result, t_first = first_half(arm)
                        t_pack = pack_half(arm, result, p == "staged")
                        del result
                        two_samples[f"first half {p} {arm}"].append(t_first)
                        two_samples[f"pack {p} {arm}"].append(t_pack)
                        two_samples[f"host {p} {arm}"].append(t_first + t_pack)
            for k, (fn, env, ctx, _) in timed.items():
                with scoped_env(env), lowered_bound(bounds_of.get(k, onedispatch.MAX_DEVICE_TABLE_SYMBOLS)), \
                        arm_of(arm, ctx):
                    t0 = time.perf_counter()
                    fn()
                    two_samples[f"{k} {arm}"].append((time.perf_counter() - t0) * 1e3)
    mp_of = {k: mp for k, (_, _, _, mp) in timed.items()}
    for k, v in two_samples.items():
        med = statistics.median(v)
        base = k.rsplit(" ", 1)[0]
        rate = f", {mp_of[base] / med * 1e3:.1f} Mpix/s" if base in mp_of else ""
        log(f"two-dispatch {k}: median {med:.4f} ms ({min(v):.4f}-{max(v):.4f}) of {len(v)}{rate} "
            f"on {gpu}")
    instances = sorted((p.idle[0].kind, p.idle[0].bytes, len(p.idle)) for p in list(programs.POOLS)
                       if p.idle and p.idle[0].kind in two_kinds)
    log("two-dispatch programs' instances (kind, graph pool bytes, idle instances): "
        f"{instances}; all captured instances {programs.graph_bytes()} bytes; torch.cuda."
        f"memory_reserved {torch.cuda.memory_reserved(dev)} bytes; graph replays so far "
        f"{json.dumps(replays)}; phase {time.perf_counter() - t_phase:.1f} s")

    # --- 6. the bench stage and the projection -------------------------------
    # the bench in its own process, whose launch counts start at 0 and are
    # read at its end; every final metric present, the device-program one
    # last, no stage failed
    from dmmt_jpeg_encoder_tpu_torch import bench
    from dmmt_jpeg_encoder_tpu_torch.parallel import projection

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "dmmt_jpeg_encoder_tpu_torch.bench", "--rounds",
                           str(BENCH_ROUNDS), "--attempts", "1", "--attempt-timeout", "600"],
                          cwd=REPO, capture_output=True, text=True, timeout=660)
    for line in proc.stderr.splitlines():
        log(f"bench: {line}")
    finals = [json.loads(line) for line in proc.stdout.splitlines()
              if line.startswith("{") and json.loads(line).get("final")]
    for line in finals:
        log(json.dumps(line))
    if proc.returncode != 0:
        raise AssertionError(f"bench exited {proc.returncode}")
    if [m["metric"] for m in finals] != bench.METRIC_ORDER:
        raise AssertionError(f"bench final metrics {[m['metric'] for m in finals]} are not "
                             f"{bench.METRIC_ORDER}")
    counts = json.loads(proc.stderr.split("bench launches: ")[-1].splitlines()[0])
    log(f"bench launches: {counts}")
    for k, n in counts.items():
        if (n == 0) if k in BENCH_KERNELS else (n != 0):
            raise AssertionError(f"bench: {k} launched {n} times, expected "
                                 f"{'at least one' if k in BENCH_KERNELS else 0}")
        launches[k] += n
    log(f"bench: {len(finals)} final metrics, every stage's JPEGs == references, "
        f"{time.perf_counter() - t0:.1f} s with process start")
    # efficiency is against one image on one card, so it is 1 at n = 1
    # only without a slab; slab_b=None takes the gate's depth per n
    for slab_b in (1, None):
        table = projection.projected_scaling_table(slab_b=slab_b)
        for row in table:
            log(f"projection (one card's floors, slab_b={slab_b}): {json.dumps(row)}")
        depths = [projection.best_slab_b(2160, r["chips"]) if slab_b is None else 1 for r in table]
        if (slab_b == 1 and table[0]["proj_efficiency"] != 1.0) \
                or [r["slab_b"] for r in table] != depths \
                or not all(0 < r["proj_ms_per_image"] < float("inf") for r in table):
            raise AssertionError(f"projection table is not sound: {table}")

    kernels = [
        {"name": k, "route": "cuda", "source": source, "replaces": rep, "launches": launches[k],
         "max_abs_err": errs[k], "ms": timing[k][0], "plain_ms": timing[k][1],
         "bound_ms": bounds[k][0], "bound_by": bounds[k][1], "library_ms": library[k]}
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
