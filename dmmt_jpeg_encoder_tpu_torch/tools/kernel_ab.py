"""Kernels of this checkout against another build of the same C entry
points, on one card, in one process.

    python -m dmmt_jpeg_encoder_tpu_torch.tools.kernel_ab OTHER_CSRC [--rounds N]
        [--kinds dct,lookup,phase1,phase1_mm,block_hist,scan_pack,scan_pack_slab,
                 plane_dct_mm,pack_emissions,histogram,plane_dct]
        [--split] [--split-this]

OTHER_CSRC is a csrc/ directory, for example the parent commit's unpacked
with git archive. Its sources of the chosen kinds (with the headers beside
them) are compiled with this checkout's nvcc flags into a library of their
own under build/kernels/. The inputs are those the paths give the kernels,
captured from encodes of the fixtures of tests/torch_port_fixtures.py:

- dct: the FUSED variant's luma, Cb and Cr blocks of the 3840x2160 P420
  frame (block_dct.cu, three calls);
- lookup: the staged pack's two lookups of that frame (DMMT_NO_FUSED_PACK=1,
  one_dispatch="off") and the fused batch's two grouped lookups of the
  16 x 1080p batch (table_lookup.cu);
- phase1: the frame's pixels as the one-dispatch encode gives them to the
  phase-1 kernel (phase1.cu); phase1_mm: the same pixels as DMMT_P1=fused1
  gives them to the fused matmul phase 1 (fused_phase1.cu);
- block_hist: the frame's two block-histogram calls of the one-dispatch
  encode, luma, then Cb and Cr (block_hist.cu);
- scan_pack: the frame's scan as the one-dispatch encode gives it to the
  scan-pack kernel, alone and with a `valid` mask that keeps the first half
  of the MCUs (as chip_smoke.py builds it); scan_pack_slab: the 16 x 1080p
  slab of the one-pack encode (DMMT_SLAB_ONEPACK=1), alone and with a
  [B, N] mask that keeps image i's first (i + 1) / (B + 1) of its MCUs
  (scan_pack.cu). A scan-pack call is timed with the zero fill of its word
  buffer, as the wrapper runs it;
- plane_dct_mm: the frame's two matmul plane-DCT calls under DMMT_P1=mxu,
  in the route's order: Cb and Cr stacked [2160, 1920], then luma
  [2160, 3840] (mxu_dct.cu);
- pack_emissions: the staged pack's call on the frame (DMMT_NO_FUSED_PACK=1,
  one_dispatch="off") and the 16 x 1080p fused chunk's call with its
  word-aligned per-image `boff` (emission_pack.cu), each timed with the
  zero fill of its word buffer, as the wrapper runs it;
- histogram: the frame's four weighted-histogram calls under
  DMMT_HIST=pallas (one_dispatch="off": luma DC and AC, then Cb and Cr
  concatenated, DC and AC) and the 16 x 1080p fused chunk's four grouped
  calls (histogram.cu);
- plane_dct: the frame's two Arai plane-DCT calls under DMMT_P1=pallas, in
  the route's order: Cb and Cr stacked [2160, 1920], then luma
  [2160, 3840] (plane_dct.cu).

Both builds are held against the plain versions on every input, exactly.
A scan-pack source is called through the C signature it declares: the
three-launch one (scratch block_bits, chunk_sums, chunk_base, 256-block
chunks) or the one-launch one (ceil(N / TILE) + 1 int64 of look-back
state per image, TILE read from the source, zeroed in one fill with the
words as the wrapper does: fused_pack.zeroed_buffers). A block-histogram
build is called through its signature too: the one-segment one (the
chroma call on the concatenation of Cb and Cr, made outside the timed
calls, and the two zero fills of the histograms in each call, as that
wrapper ran them) or the two-segment one (the state buffer kept between
calls, no fill). A fused matmul phase-1 build takes its color constants
and DCT matrix from device memory or, where its source declares c_host,
from host memory (copied into the launch's parameters); so does a matmul
plane-DCT build for its DCT matrix. An emission-pack build that declares
block_bits is given them (int32) and writes the total bit count itself;
for one that does not, the total is computed as its wrapper did, outside
the timed calls. A weighted-histogram build that declares no state is
given an output zeroed in each call (the torch.zeros its wrapper ran);
one that declares it keeps the state between calls, with no fill. An
Arai plane-DCT build takes its constants from device memory and a float32
table (converted here, outside the timed calls) or, where its source
declares c_host, its constants from host memory and the table as the
route passes it. Rounds run in
the order other, this, this, other; every time is
tools/timing.device_ms of one call list, beside the library call that
computes the same function where there is one (torch.matmul by M,
torch.gather, torch.einsum C X C^T, torch.bincount). Prints one JSON line per (input, build, round), one summary
line with the medians (also of each call of a list alone) and the SM clock
and power draw that nvidia-smi reads while this checkout's call list runs
back to back for a second, and the float32 rate of one 8192^3
torch.matmul (cuBLAS, TF32 off) as a yardstick of what the card's FFMA
pipes reach; then the card's name and power limit.

--split times, on the scan-pack inputs, each launch of OTHER_CSRC's scan
pack alone (three-launch: bits, chunk scan, emit; one-launch: the kernel
after the zero fill of its look-back state; through a small shim that
includes its scan_pack.cu), the zero fills alone, and OTHER_CSRC's
phase-1 kernels; on the block-histogram inputs, the luma and the chroma
launch alone, the two zero fills of a one-segment call, and the
torch.cat of Cb and Cr that a one-segment chroma call needs; on the
matmul plane-DCT inputs, each launch alone and, for a build with the DCT
matrix in device memory (the earlier 8 x 128 shared-memory tiles), its
loads alone and its loads with the column pass (through a shim that
includes its dct8.cuh and repeats its kernel's stages, the rest of the
work kept behind a store that a runtime zero disables); on the
emission-pack inputs, the wrapper's torch.zeros of the word buffer, the
kernel alone (on a buffer zeroed once) and the zero fill with the kernel;
on the weighted-histogram inputs, each call alone (a build without state
on an output zeroed once, outside the timing), the wrapper's torch.zeros
of each output alone, each call as the wrapper runs it and the four
together; on the Arai plane-DCT inputs, each launch alone and the pair,
and for a build with its constants in device memory (8 x 128 tiles in
shared memory) its loads alone and its loads with the row pass (through
a shim as for the matmul plane DCT); on both plane-DCT inputs, as a
yardstick, a torch conversion of each plane to int16 (the same bytes);
with --split-this the same for this checkout's; one JSON line each.
Needs a card and nvcc.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..kernels import build
from .timing import device_ms

REPO = Path(__file__).resolve().parents[2]
KINDS = ("dct", "lookup", "phase1", "phase1_mm", "block_hist", "scan_pack", "scan_pack_slab",
         "plane_dct_mm", "pack_emissions", "histogram", "plane_dct")
SOURCES = {"dct": "block_dct.cu", "lookup": "table_lookup.cu", "phase1": "phase1.cu",
           "phase1_mm": "fused_phase1.cu", "block_hist": "block_hist.cu",
           "scan_pack": "scan_pack.cu", "scan_pack_slab": "scan_pack.cu",
           "plane_dct_mm": "mxu_dct.cu", "pack_emissions": "emission_pack.cu",
           "histogram": "histogram.cu", "plane_dct": "plane_dct.cu"}
ENTRY_POINTS = {"dct": "dmmt_block_dct_zz", "lookup": "dmmt_table_lookup_grouped",
                "phase1": "dmmt_phase1", "phase1_mm": "dmmt_phase1_mm",
                "block_hist": "dmmt_block_hist", "scan_pack": "dmmt_scan_pack",
                "scan_pack_slab": "dmmt_scan_pack_slab", "plane_dct_mm": "dmmt_plane_dct_mm",
                "pack_emissions": "dmmt_pack_emissions", "histogram": "dmmt_histogram_grouped",
                "plane_dct": "dmmt_plane_dct"}
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the plane DCTs' C signature with their constants (the matmul's DCT matrix,
# the Arai constants) and a float32 q in device memory (plane, height,
# width, constants, q, out)
DEVICE_CONSTANTS_PLANE_SIGNATURE = (_P, _I, _I, _P, _P, _P, _P)
# the weighted histogram's C signature without state (symbols, weights,
# n_groups, m, n_bins, zeroed out)
ZEROED_HIST_SIGNATURE = (_P, _P, _I, _LL, _I, _P, _P)
# the emission pack's C signature without block_bits and total_bits (values,
# lens, offs, boff, n_blocks, words, n_words)
NO_END_PACK_SIGNATURE = (_P, _P, _P, _P, _LL, _P, _LL, _P)
# the one-segment block histogram's C signature (blocks, n_blocks, n_valid,
# zeroed dc and ac)
ONE_SEGMENT_HIST_SIGNATURE = (_P, _LL, _LL, _P, _P, _P)
# the three-launch scan pack's C signatures (block_bits, chunk_sums,
# chunk_base scratch; 256-block chunks)
THREE_LAUNCH_SIGNATURES = {
    "dmmt_scan_pack": (_P, _LL, _I, _I, _P, _P, _P, _P, _P, _P, _P, _LL, _P, _P),
    "dmmt_scan_pack_slab": (_P, _I, _LL, _I, _I, _P, _P, _P, _P, _P, _P, _P, _LL, _P, _P),
}
THREE_LAUNCH_CHUNK = 256

# A shim around a three-launch scan_pack.cu: each launch alone.
SPLIT_SHIM = r"""
#include "scan_pack.cu"
extern "C" int split_bits(const short* scan, int n_images, long long n, int stride, int lpm,
                          const int* codes, const int* lens, const int* valid, int* block_bits,
                          long long* chunk_sums, void* s) {
    const long long n_chunks = (n + CHUNK - 1) / CHUNK;
    bits_kernel<<<dim3(n_chunks, n_images), THREADS, 0, (cudaStream_t)s>>>(
        scan, n, stride, lpm, codes, lens, valid, block_bits, chunk_sums);
    return cudaGetLastError();
}
extern "C" int split_scan(const long long* chunk_sums, int n_images, long long n_chunks,
                          long long* chunk_base, long long* total_bits, void* s) {
    chunk_scan_kernel<<<n_images, SCAN_THREADS, 0, (cudaStream_t)s>>>(chunk_sums, n_chunks,
                                                                      chunk_base, total_bits);
    return cudaGetLastError();
}
extern "C" int split_emit(const short* scan, int n_images, long long n, int stride, int lpm,
                          const int* codes, const int* lens, const int* valid,
                          const int* block_bits, const long long* chunk_base, unsigned* words,
                          long long n_words, void* s) {
    const long long n_chunks = (n + CHUNK - 1) / CHUNK;
    emit_kernel<<<dim3(n_chunks, n_images), THREADS, 0, (cudaStream_t)s>>>(
        scan, n, stride, lpm, codes, lens, valid, block_bits, chunk_base, words, n_words);
    return cudaGetLastError();
}
"""
# A shim around a matmul plane-DCT build whose kernel stages 8 x 128 tiles
# in shared memory (the earlier design): the same grid, loads and column
# pass, each stage alone; the rest is kept behind a store that sink = 0
# disables at run time.
MM_SPLIT_SHIM = r"""
#include "dct8.cuh"
using namespace dmmt;
namespace {
constexpr int TILE_W = 128, LD = TILE_W + 1, THREADS = 128;
template <bool COLUMNS>
__global__ void __launch_bounds__(THREADS) stage_kernel(
    const float* __restrict__ plane, int width, int tiles_x, const float* __restrict__ c,
    const float* __restrict__ q, short* __restrict__ out, int sink) {
    __shared__ float s_c[64];
    __shared__ float s_q[64];
    __shared__ float s[8 * LD];
    const int tid = threadIdx.x;
    for (int i = tid; i < 64; i += THREADS) {
        s_c[i] = c[i];
        s_q[i] = q[i];
    }
    const int row0 = (blockIdx.x / tiles_x) * 8, col0 = (blockIdx.x % tiles_x) * TILE_W;
    const int valid = min(TILE_W, width - col0);
    for (int i = tid; i < 8 * TILE_W; i += THREADS) {
        const int r = i / TILE_W, col = i % TILE_W;
        s[r * LD + col] = col < valid ? plane[static_cast<size_t>(row0 + r) * width + col0 + col] : 0.0f;
    }
    __syncthreads();
    if (COLUMNS) {
        for (int i = tid; i < TILE_W; i += THREADS) {
            float* col = s + i;
            float x[8];
            for (int y = 0; y < 8; ++y) x[y] = col[y * LD];
            for (int v = 0; v < 8; ++v) col[v * LD] = contract8(x, s_c + v * 8);
        }
        __syncthreads();
    }
    if (sink)
        out[static_cast<size_t>(blockIdx.x) * THREADS + tid] = static_cast<short>(s[tid] + s_q[tid % 64]);
}
}  // namespace
extern "C" int split_mm(const float* plane, int height, int width, const float* c, const float* q,
                        short* out, int columns, int sink, void* stream) {
    const int tiles_x = (width + TILE_W - 1) / TILE_W;
    const dim3 grid(tiles_x * (height / 8));
    const cudaStream_t s = (cudaStream_t)stream;
    if (columns)
        stage_kernel<true><<<grid, THREADS, 0, s>>>(plane, width, tiles_x, c, q, out, sink);
    else
        stage_kernel<false><<<grid, THREADS, 0, s>>>(plane, width, tiles_x, c, q, out, sink);
    return cudaGetLastError();
}
"""
# A shim around an Arai plane-DCT build whose kernel stages 8 x 128 tiles in
# shared memory with its constants (the earlier design): the same grid, the
# loads of the constants, the table and the tile, and the row pass, each
# stage alone; the rest kept behind a store that sink = 0 disables.
PLANE_SPLIT_SHIM = r"""
#include "dct8.cuh"
using namespace dmmt;
namespace {
constexpr int TILE_W = 128, LD = TILE_W + 1, THREADS = 128;
template <bool ROWS>
__global__ void __launch_bounds__(THREADS) stage_kernel(
    const float* __restrict__ plane, int width, int tiles_x, const float* __restrict__ consts,
    const float* __restrict__ q, short* __restrict__ out, int sink) {
    __shared__ float s_k[K_COUNT];
    __shared__ float s_q[64];
    __shared__ float s[8 * LD];
    const int tid = threadIdx.x;
    for (int i = tid; i < K_COUNT; i += THREADS) s_k[i] = consts[i];
    for (int i = tid; i < 64; i += THREADS) s_q[i] = q[i];
    const int row0 = (blockIdx.x / tiles_x) * 8, col0 = (blockIdx.x % tiles_x) * TILE_W;
    const int valid = min(TILE_W, width - col0);
    for (int i = tid; i < 8 * TILE_W; i += THREADS) {
        const int r = i / TILE_W, c = i % TILE_W;
        s[r * LD + c] = c < valid ? plane[static_cast<size_t>(row0 + r) * width + col0 + c] : 0.0f;
    }
    __syncthreads();
    if (ROWS) {
        for (int i = tid; i < 8 * (TILE_W / 8); i += THREADS) {
            const int r = i % 8, g = i / 8;
            if (g * 8 < valid) arai8(&s[r * LD + g * 8], 1, s_k);
        }
        __syncthreads();
    }
    if (sink)
        out[static_cast<size_t>(blockIdx.x) * THREADS + tid] = static_cast<short>(s[tid] + s_q[tid % 64]);
}
}  // namespace
extern "C" int split_plane(const float* plane, int height, int width, const float* consts,
                           const float* q, short* out, int rows, int sink, void* stream) {
    const int tiles_x = (width + TILE_W - 1) / TILE_W;
    const dim3 grid(tiles_x * (height / 8));
    const cudaStream_t s = (cudaStream_t)stream;
    if (rows)
        stage_kernel<true><<<grid, THREADS, 0, s>>>(plane, width, tiles_x, consts, q, out, sink);
    else
        stage_kernel<false><<<grid, THREADS, 0, s>>>(plane, width, tiles_x, consts, q, out, sink);
    return cudaGetLastError();
}
"""
SPLIT_SIGNATURES = {
    "split_bits": (_P, _I, _LL, _I, _I, _P, _P, _P, _P, _P, _P),
    "split_scan": (_P, _I, _LL, _P, _P, _P),
    "split_emit": (_P, _I, _LL, _I, _I, _P, _P, _P, _P, _P, _P, _LL, _P),
}


def three_launch(csrc: Path) -> bool:
    """Whether csrc's scan_pack.cu declares the three-launch C signature."""
    return "long long* chunk_base" in (csrc / "scan_pack.cu").read_text()


def convention(csrc: Path, kind: str) -> int:
    """How to call csrc's kernel of `kind`. Scan pack: 0 for the
    three-launch signature, else the blocks per tile of the one-launch one.
    Block histogram: 0 for one segment, 1 for two. Fused matmul phase 1
    and matmul plane DCT: 0 for constants in device memory, 1 for host
    memory; Arai plane DCT the same (1 also takes the table as passed).
    Emission pack: 0 without block_bits, 1 with (the kernel writes the
    total bit count). Weighted histogram: 0 for an output zeroed by the
    caller, 1 for the state buffer. Else 0."""
    if kind.startswith("scan_pack"):
        if three_launch(csrc):
            return 0
        return int(re.search(r"constexpr int TILE = (\d+);", (csrc / "scan_pack.cu").read_text())[1])
    if kind == "block_hist":
        return int("long long n_blocks, long long n_valid" not in (csrc / "block_hist.cu").read_text())
    if kind in ("phase1_mm", "plane_dct_mm", "plane_dct"):
        return int("c_host" in (csrc / SOURCES[kind]).read_text())
    if kind == "histogram":
        return int("long long* state" in (csrc / "histogram.cu").read_text())
    if kind == "pack_emissions":
        return int("const int* block_bits" in (csrc / "emission_pack.cu").read_text())
    return 0


def _compile(srcs: list[Path], tag: str, extra: tuple = (), included: tuple = ()) -> Path:
    """Compile srcs into one library under build/kernels/, keyed by their
    contents, the headers beside them and the `included` files."""
    h = hashlib.sha256(" ".join(build.NVCC_FLAGS + extra).encode())
    for s in [*srcs, *included, *sorted({x for s in srcs for x in s.parent.glob("*.cuh")})]:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    out = build.BUILD_DIR / f"{tag}_{h.hexdigest()[:16]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        objs = [out.with_name(f"{out.stem}.{s.stem}.o") for s in srcs]
        procs = [subprocess.Popen(build.compile_command(s, o)[:-1] + [*extra, str(s)],
                                  stderr=subprocess.PIPE, text=True) for s, o in zip(srcs, objs)]
        for s, p in zip(srcs, procs):
            _, err = p.communicate()
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {s}:\n{err}")
        subprocess.run(build.link_command(objs, out), check=True, capture_output=True)
    return out


def _bind(lib: ctypes.CDLL, signatures: dict) -> ctypes.CDLL:
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def build_other(csrc: Path, kinds: list[str]) -> ctypes.CDLL:
    """Compile and load the kernels of `kinds` from another csrc/ directory."""
    srcs = sorted({csrc / SOURCES[k] for k in kinds})
    lib = ctypes.CDLL(str(_compile(srcs, "kernel_ab")))
    sigs = {ENTRY_POINTS[k]: build._SIGNATURES[ENTRY_POINTS[k]] for k in kinds}
    if csrc.joinpath("scan_pack.cu") in srcs and three_launch(csrc):
        sigs.update({k: v for k, v in THREE_LAUNCH_SIGNATURES.items() if k in sigs})
    if "block_hist" in kinds and not convention(csrc, "block_hist"):
        sigs["dmmt_block_hist"] = ONE_SEGMENT_HIST_SIGNATURE
    if "pack_emissions" in kinds and not convention(csrc, "pack_emissions"):
        sigs["dmmt_pack_emissions"] = NO_END_PACK_SIGNATURE
    if "plane_dct_mm" in kinds and not convention(csrc, "plane_dct_mm"):
        sigs["dmmt_plane_dct_mm"] = DEVICE_CONSTANTS_PLANE_SIGNATURE
    if "plane_dct" in kinds and not convention(csrc, "plane_dct"):
        sigs["dmmt_plane_dct"] = DEVICE_CONSTANTS_PLANE_SIGNATURE
    if "histogram" in kinds and not convention(csrc, "histogram"):
        sigs["dmmt_histogram_grouped"] = ZEROED_HIST_SIGNATURE
    return _bind(lib, sigs)


def build_stage_split(csrc: Path, kind: str) -> ctypes.CDLL:
    """The stages of csrc's shared-memory-tile plane DCT of `kind`, behind
    split_mm (MM_SPLIT_SHIM) or split_plane (PLANE_SPLIT_SHIM)."""
    name, text = (("split_mm", MM_SPLIT_SHIM) if kind == "plane_dct_mm"
                  else ("split_plane", PLANE_SPLIT_SHIM))
    shim = build.BUILD_DIR / "split_shim" / f"{name}.cu"
    shim.parent.mkdir(parents=True, exist_ok=True)
    shim.write_text(text)
    out = _compile([shim], f"kernel_ab_{name}", ("-I", str(csrc)), (csrc / "dct8.cuh",))
    return _bind(ctypes.CDLL(str(out)), {name: (_P, _I, _I, _P, _P, _P, _I, _I, _P)})


def build_split(csrc: Path) -> ctypes.CDLL:
    """The launches of csrc's three-launch scan_pack.cu, each behind its own
    entry point."""
    shim = build.BUILD_DIR / "split_shim" / "scan_pack_split.cu"
    shim.parent.mkdir(parents=True, exist_ok=True)
    shim.write_text(SPLIT_SHIM)
    out = _compile([shim], "kernel_ab_split", ("-I", str(csrc)), (csrc / "scan_pack.cu",))
    return _bind(ctypes.CDLL(str(out)), SPLIT_SIGNATURES)


@contextlib.contextmanager
def _patched(module, name: str, wrap):
    real = getattr(module, name)
    setattr(module, name, wrap(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def _contig(x: torch.Tensor) -> torch.Tensor:
    return x.clone(memory_format=torch.contiguous_format)


def _prefix_mask(n_scan: int, stride: int, n_images: int | None, dev) -> torch.Tensor:
    """chip_smoke.py's masks: one image keeps the first half of its MCUs;
    image i of B keeps the first (i + 1) / (B + 1)."""
    idx = torch.arange(n_scan, device=dev)
    if n_images is None:
        return (idx < n_scan // stride // 2 * stride).to(torch.int32)
    keep = torch.tensor([n_scan // stride * (i + 1) // (n_images + 1) * stride
                         for i in range(n_images)], device=dev)
    return (idx[None] < keep[:, None]).to(torch.int32)


def capture_inputs(dev: torch.device, kinds: list[str]) -> dict:
    """{input name: (kind, [call arguments, ...])}: each kernel's inputs as
    the encodes pass them (with the encode's output for dct and lookup)."""
    import dmmt_jpeg_encoder_tpu_torch as port
    from .. import onedispatch, programs
    from ..bitstream import device_pack, emission_pack
    from ..ops import block_hist, fused, fused_arai, fused_phase1, histogram, mxu_dct, pallas_dct
    from ..pipeline import row_stack
    from ..tables import quantization_table_pair
    from ..utils.device import as_device
    from torch_port_fixtures import BATCH_FIXTURES, batch_frames, fixture_pixels

    calls: list = []
    hist_calls: list = []

    def grab_dct(real):
        def wrapped(blocks, qtable):
            out = real(blocks, qtable)
            m = torch.from_numpy(fused.fused_matrix(qtable)).to(blocks.device).contiguous()
            calls.append((_contig(blocks), m, out.clone()))
            return out
        return wrapped

    def grab_lookup(real):
        def wrapped(symbols, tables):
            out = real(symbols, tables)
            calls.append((_contig(symbols.to(torch.int32)), _contig(tables.to(torch.int32)), out.clone()))
            return out
        return wrapped

    def grab_phase1(real):
        # fused_phase1 also takes `split` (DMMT_P1_PREC=high), timed unsplit here
        def wrapped(rgb, maxval, luma_q, chroma_q, preset, *split):
            calls.append((_contig(rgb), maxval, _contig(luma_q), _contig(chroma_q), preset))
            return real(rgb, maxval, luma_q, chroma_q, preset, *split)
        return wrapped

    def grab_hist(real):
        def wrapped(coeffs_zz, n_valid=None, state=None):
            segs = coeffs_zz if isinstance(coeffs_zz, (tuple, list)) else (coeffs_zz,)
            hist_calls.append(tuple(_contig(x) for x in segs))
            return real(coeffs_zz, n_valid, state)
        return wrapped

    def grab_mm(real):
        # plane_dct_quant_mxu also takes split=, timed unsplit here
        def wrapped(plane, qtable, **split):
            calls.append((_contig(plane), qtable.to(plane.device).contiguous()))
            return real(plane, qtable, **split)
        return wrapped

    def grab_weighted(real):
        def wrapped(symbols, weights, n_bins, state=None):
            calls.append((_contig(symbols.to(torch.int32)), _contig(weights.to(torch.int32)), n_bins))
            return real(symbols, weights, n_bins, state)
        return wrapped

    def grab_emissions(real):
        def wrapped(values, lens, offs, block_bits, n_words, boff=None):
            calls.append((*(_contig(x.to(torch.int32)) for x in (values, lens, offs)),
                          _contig(block_bits), n_words, None if boff is None else _contig(boff)))
            return real(values, lens, offs, block_bits, n_words, boff)
        return wrapped

    def grab_pack(real):
        def wrapped(scan, stride, lpm, codes, lens, n_words, valid=None):
            calls.append((_contig(scan), stride, lpm, _contig(codes.to(torch.int32)),
                          _contig(lens.to(torch.int32)), n_words))
            return real(scan, stride, lpm, codes, lens, n_words, valid)
        return wrapped

    px = fixture_pixels("4k_p420")
    cfg = port.EncoderConfig(chroma_subsampling=port.ChromaSubsamplingPreset.P420)
    fb = BATCH_FIXTURES["batch_1080p_p420"]
    frames = batch_frames("batch_1080p_p420")
    lq, cq = quantization_table_pair(cfg.quantization_preset, cfg.quality)

    def encode_eager(config, slab=False):
        """The one-dispatch encode of the 4K frame (the 1080p batch as one
        slab) op by op, onedispatch._enqueue, so that every wrapper call
        passes the grabs: a start on a card replays a captured graph."""
        if slab:
            rgb = row_stack(np.stack(frames), fb["maxval"], config.chroma_subsampling, dev)
            states = onedispatch._enqueue(rgb, len(frames), fb["maxval"], config, lq, cq,
                                          onedispatch.slab_onepack_enabled())
        else:
            rgb = as_device(px, 255, dev)
            states = onedispatch._enqueue(rgb, 1, 255, config, lq, cq, False)
        for state in states:
            onedispatch.finish_one_dispatch(state)

    def eager_two_dispatch():
        """The two-dispatch halves op by op (programs.card naming no card),
        so that every wrapper call passes the grabs."""
        return _patched(programs, "card", lambda real: lambda pixels, device: None)

    inputs = {}
    if "dct" in kinds:
        with _patched(fused, "fused_dct_quantize_zigzag", grab_dct):
            encode_eager(dataclasses.replace(cfg, dct_variant=port.DCTVariant.FUSED))
        inputs["block_dct_zz 4k_p420 FUSED (luma, Cb, Cr)"] = ("dct", calls[:])
        calls.clear()
    if "lookup" in kinds:
        os.environ["DMMT_NO_FUSED_PACK"] = "1"
        try:
            with _patched(device_pack, "table_lookup_grouped", grab_lookup), eager_two_dispatch():
                port.encode_array(px, 255, dataclasses.replace(cfg, one_dispatch="off"), device=dev)
                inputs["table_lookup 4k_p420 staged pack (DC, AC)"] = ("lookup", calls[:])
                calls.clear()
                port.encode_batch(frames, fb["maxval"], cfg, fused_batch=fb["n"], device=dev)
                inputs[f"table_lookup batch_1080p_p420 fused_batch={fb['n']} (DC, AC)"] = (
                    "lookup", calls[:])
                calls.clear()
        finally:
            os.environ.pop("DMMT_NO_FUSED_PACK")
    if {"phase1", "block_hist", "scan_pack"} & set(kinds):
        with _patched(fused_arai, "fused_arai_phase1", grab_phase1), \
                _patched(onedispatch, "fused_pack_words", grab_pack), \
                _patched(block_hist, "fused_block_histograms", grab_hist):
            encode_eager(cfg)
        p1, pack = calls
        calls.clear()
        if "phase1" in kinds:
            inputs["phase1 4k_p420 (uint8 P420)"] = ("phase1", [p1])
        if "block_hist" in kinds:
            inputs["block_hist 4k_p420 (luma; Cb, Cr)"] = ("block_hist", hist_calls[:])
        if "scan_pack" in kinds:
            n, stride = int(pack[0].shape[0]), pack[1]
            inputs["scan_pack 4k_p420"] = ("scan_pack", [(*pack, None)])
            inputs["scan_pack 4k_p420 valid prefix"] = (
                "scan_pack", [(*pack, _prefix_mask(n, stride, None, dev))])
    if "phase1_mm" in kinds:
        os.environ["DMMT_P1"] = "fused1"
        try:
            with _patched(fused_phase1, "fused_phase1", grab_phase1):
                encode_eager(cfg)
        finally:
            os.environ.pop("DMMT_P1")
        inputs["phase1_mm 4k_p420 (uint8 P420, DMMT_P1=fused1)"] = ("phase1_mm", calls[:])
        calls.clear()
    if "scan_pack_slab" in kinds:
        os.environ["DMMT_SLAB_ONEPACK"] = "1"
        try:
            with _patched(onedispatch, "fused_pack_words_slab", grab_pack):
                encode_eager(cfg, slab=True)
        finally:
            os.environ.pop("DMMT_SLAB_ONEPACK")
        (slab,) = calls
        calls.clear()
        b, n, stride = int(slab[0].shape[0]), int(slab[0].shape[1]), slab[1]
        inputs[f"scan_pack_slab batch_1080p_p420 x {b}"] = ("scan_pack_slab", [(*slab, None)])
        inputs[f"scan_pack_slab batch_1080p_p420 x {b} valid prefixes"] = (
            "scan_pack_slab", [(*slab, _prefix_mask(n, stride, b, dev))])
    if "plane_dct_mm" in kinds:
        os.environ["DMMT_P1"] = "mxu"
        try:
            with _patched(mxu_dct, "plane_dct_quant_mxu", grab_mm):
                encode_eager(cfg)
        finally:
            os.environ.pop("DMMT_P1")
        inputs["plane_dct_mm 4k_p420 DMMT_P1=mxu (Cb, Cr stacked; luma)"] = ("plane_dct_mm", calls[:])
        calls.clear()
    if "pack_emissions" in kinds:
        with _patched(emission_pack, "pack_emission_words", grab_emissions), eager_two_dispatch():
            os.environ["DMMT_NO_FUSED_PACK"] = "1"
            try:
                port.encode_array(px, 255, dataclasses.replace(cfg, one_dispatch="off"), device=dev)
            finally:
                os.environ.pop("DMMT_NO_FUSED_PACK")
            inputs["pack_emissions 4k_p420 staged pack"] = ("pack_emissions", calls[:])
            calls.clear()
            port.encode_batch(frames, fb["maxval"], cfg, fused_batch=fb["n"], device=dev)
            inputs[f"pack_emissions batch_1080p_p420 fused_batch={fb['n']}"] = ("pack_emissions", calls[:])
            calls.clear()
    if "histogram" in kinds:
        with _patched(histogram, "histogram_grouped", grab_weighted), eager_two_dispatch():
            os.environ["DMMT_HIST"] = "pallas"
            try:
                port.encode_array(px, 255, dataclasses.replace(cfg, one_dispatch="off"), device=dev)
            finally:
                os.environ.pop("DMMT_HIST")
            inputs["histogram 4k_p420 DMMT_HIST=pallas (luma DC, AC; Cb+Cr DC, AC)"] = (
                "histogram", calls[:])
            calls.clear()
            port.encode_batch(frames, fb["maxval"], cfg, fused_batch=fb["n"], device=dev)
            inputs[f"histogram batch_1080p_p420 fused_batch={fb['n']} (luma DC, AC; Cb+Cr DC, AC)"] = (
                "histogram", calls[:])
            calls.clear()
    if "plane_dct" in kinds:
        os.environ["DMMT_P1"] = "pallas"
        try:
            with _patched(pallas_dct, "plane_dct_quant", grab_mm):
                encode_eager(cfg)
        finally:
            os.environ.pop("DMMT_P1")
        inputs["plane_dct 4k_p420 DMMT_P1=pallas (Cb, Cr stacked; luma)"] = ("plane_dct", calls[:])
        calls.clear()
    torch.cuda.synchronize()
    return inputs


def _ptr(x: torch.Tensor | None):
    return None if x is None else x.data_ptr()


def _arg(x):
    """A C argument: a tensor's or array's address, else the value."""
    if isinstance(x, torch.Tensor):
        return x.data_ptr()
    if isinstance(x, np.ndarray):
        return x.ctypes.data
    return x


def _phase1_args(call) -> tuple:
    """(pixels, C arguments after the pixels' pointer, outputs) of one
    phase-1 call, as the wrapper makes them."""
    from ..ops.fused_arai import kernel_constants
    from ..ops.geometry import padded_size

    rgb, maxval, lq, cq, preset = call
    dev = rgb.device
    h, w = int(rgb.shape[0]), int(rgb.shape[1])
    ph, pw = padded_size(h, w, preset)
    hr, vr = preset.horizontal_rate, preset.vertical_rate
    n_mcu = (ph // (8 * vr)) * (pw // (8 * hr))
    outs = [torch.empty((n, 64), dtype=torch.int16, device=dev) for n in (n_mcu * hr * vr, n_mcu, n_mcu)]
    consts = torch.from_numpy(kernel_constants()).to(dev)
    qs = [q.to(device=dev, dtype=torch.float32).contiguous() for q in (lq, cq)]
    return (rgb, (rgb.element_size(), h, w, hr, vr, float(maxval), consts, *qs, *outs), outs)


def _phase1_mm_args(call, conv: int) -> tuple:
    """(pixels, C arguments after the pixels' pointer, outputs) of one fused
    matmul phase-1 call in the build's convention (conv 1: the color
    constants and the DCT matrix from host memory)."""
    from ..ops.dct import dct_matrix
    from ..ops.fused_arai import kernel_constants
    from ..ops.geometry import padded_size

    rgb, maxval, lq, cq, preset = call
    dev = rgb.device
    h, w = int(rgb.shape[0]), int(rgb.shape[1])
    ph, pw = padded_size(h, w, preset)
    hr, vr = preset.horizontal_rate, preset.vertical_rate
    outs = [torch.empty((ph, pw), dtype=torch.int16, device=dev)]
    outs += [torch.empty((ph // vr, pw // hr), dtype=torch.int16, device=dev) for _ in range(2)]
    consts = [kernel_constants(), dct_matrix()]
    if not conv:
        consts = [torch.from_numpy(x).to(dev) for x in consts]
    qs = [q.to(device=dev, dtype=torch.float32).contiguous() for q in (lq, cq)]
    return (rgb, (rgb.element_size(), h, w, hr, vr, float(maxval), *consts, *qs, *outs), outs)


def _hist_buffers(call, conv: int) -> tuple:
    """(C arguments, the tensors the call zero-fills first, outputs) of one
    block-histogram call in the build's convention: one segment (Cb and Cr
    concatenated here, zeroed dc and ac) or two (the state kept between
    calls, zeroed once; an unfilled [272] output)."""
    dev = call[0].device
    if conv:
        from ..ops.block_hist import STATE_INTS

        a, b = call[0], (call[1] if len(call) > 1 else None)
        state = torch.zeros(STATE_INTS, dtype=torch.int32, device=dev)
        out = torch.empty(272, dtype=torch.int32, device=dev)
        cargs = (a, int(a.shape[0]), b, 0 if b is None else int(b.shape[0]), state, out)
        return cargs, (), [out[:16], out[16:]]
    x = call[0] if len(call) == 1 else torch.cat(call)
    dc, ac = (torch.zeros(n, dtype=torch.int32, device=dev) for n in (16, 256))
    n = int(x.shape[0])
    return (x, n, n, dc, ac), (dc, ac), [dc, ac]


def _pack_buffers(call, conv: int, kind: str) -> tuple:
    """(words, total_bits, scratch tensors, the tensor the wrapper zero-fills
    before each call) of one scan-pack call in the build's convention."""
    from ..bitstream.fused_pack import zeroed_buffers

    scan, n_words = call[0], call[5]
    dev = scan.device
    b = int(scan.shape[0]) if kind == "scan_pack_slab" else 1
    n = int(scan.shape[-2])
    total = torch.empty(b, dtype=torch.int64, device=dev)
    if conv:
        buf, words, state = zeroed_buffers(b, n_words, n, dev, conv)
        return (words if kind == "scan_pack_slab" else words[0]), total, (state,), buf
    words = torch.zeros((b, n_words) if kind == "scan_pack_slab" else n_words, dtype=torch.int32,
                        device=dev)
    chunks = -(-n // THREE_LAUNCH_CHUNK)
    scratch = (torch.empty((b, n), dtype=torch.int32, device=dev),
               torch.empty((b, chunks), dtype=torch.int64, device=dev),
               torch.empty((b, chunks), dtype=torch.int64, device=dev))
    return words, total, scratch, words


def _plane_args(call, conv: int, kind: str) -> tuple:
    """(C arguments, output) of one plane-DCT call of `kind` in the build's
    convention: conv 1, the constants (the matmul's DCT matrix, the Arai
    constants) from host memory and the table as the route passes it
    (uint8, flagged); conv 0, both in device memory, the table as float32
    (converted here, outside the timed calls)."""
    from ..ops.dct import dct_matrix
    from ..ops.fused_arai import kernel_constants

    plane, q = call
    h, w = int(plane.shape[0]), int(plane.shape[1])
    out = torch.empty(plane.shape, dtype=torch.int16, device=plane.device)
    consts = dct_matrix() if kind == "plane_dct_mm" else kernel_constants()
    if conv:
        if q.dtype != torch.uint8:
            q = q.to(torch.float32).contiguous()
        return (plane, h, w, consts, q, int(q.dtype == torch.uint8), out), out
    consts = torch.from_numpy(consts).to(plane.device)
    return (plane, h, w, consts, q.to(torch.float32).contiguous(), out), out


def _weighted_hist_args(call, conv: int) -> tuple:
    """(C arguments, the output the caller zero-fills in each call (conv 0;
    none for conv 1, whose state is zeroed once), output) of one
    weighted-histogram call in the build's convention."""
    symbols, weights, n_bins = call
    g, m = int(symbols.shape[0]), int(symbols.shape[1])
    dev = symbols.device
    if conv:
        from ..ops.block_hist import STATE_INTS

        state = torch.zeros(STATE_INTS, dtype=torch.int32, device=dev)
        out = torch.empty((g, n_bins), dtype=torch.int32, device=dev)
        return (symbols, weights, g, m, n_bins, state, out), (), out
    out = torch.zeros((g, n_bins), dtype=torch.int32, device=dev)
    return (symbols, weights, g, m, n_bins, out), (out,), out


def _emission_args(call, conv: int) -> tuple:
    """(C arguments, the word buffer the wrapper zero-fills, outputs) of one
    emission-pack call in the build's convention (conv 1: block_bits in,
    the total bit count out)."""
    from ..bitstream.device_pack import block_offsets

    values, lens, offs, block_bits, n_words, boff = call
    boff, total = block_offsets(block_bits, boff)
    boff = boff.contiguous()
    n = int(values.shape[0])
    words = torch.zeros(n_words, dtype=torch.int32, device=values.device)
    if conv:
        total = torch.empty((), dtype=torch.int64, device=values.device)
        bits = block_bits.to(torch.int32).contiguous()
        return (values, lens, offs, boff, bits, n, words, n_words, total), words, (words, total)
    return (values, lens, offs, boff, n, words, n_words), words, (words, total)


def runner(lib, kind: str, args: list, conv: int = 0):
    """(the call list on `lib`, one closure per call, their outputs): one C
    call per captured call; a scan-pack call zero-fills its words (and a
    one-launch build's look-back state) first, as the wrapper does."""
    entry = ENTRY_POINTS[kind]
    prepared, outs = [], []
    for call in args:
        if kind in ("dct", "lookup"):
            a = call[0]
            outs.append(torch.empty((a.shape[0], 64) if kind == "dct" else a.shape,
                                    dtype=torch.int16 if kind == "dct" else torch.int32,
                                    device=a.device))
        elif kind in ("phase1", "phase1_mm"):
            rgb, cargs, o = _phase1_args(call) if kind == "phase1" else _phase1_mm_args(call, conv)
            prepared.append((rgb, cargs))
            outs.append(o)
        elif kind == "block_hist":
            cargs, fills, o = _hist_buffers(call, conv)
            prepared.append((cargs, fills))
            outs.append(o)
        elif kind in ("plane_dct_mm", "plane_dct"):
            cargs, o = _plane_args(call, conv, kind)
            prepared.append((cargs, ()))
            outs.append(o)
        elif kind == "histogram":
            cargs, fills, o = _weighted_hist_args(call, conv)
            prepared.append((cargs, fills))
            outs.append(o)
        elif kind == "pack_emissions":
            cargs, fill, o = _emission_args(call, conv)
            prepared.append((cargs, (fill,)))
            outs.append(o)
        else:
            bufs = _pack_buffers(call, conv, kind)
            prepared.append(bufs)
            outs.append(bufs[:2])

    def one(k: int) -> None:
        stream_ = torch.cuda.current_stream().cuda_stream
        if kind == "dct":
            (a, b, _), o = args[k], outs[k]
            err = lib.dmmt_block_dct_zz(a.data_ptr(), int(a.shape[0]), b.data_ptr(), o.data_ptr(), stream_)
        elif kind == "lookup":
            (a, b, _), o = args[k], outs[k]
            err = lib.dmmt_table_lookup_grouped(a.data_ptr(), b.data_ptr(), int(a.shape[0]),
                                                int(a.shape[1]), int(b.shape[1]), o.data_ptr(), stream_)
        elif kind in ("phase1", "phase1_mm"):
            rgb, cargs = prepared[k]
            err = getattr(lib, entry)(rgb.data_ptr(), *(_arg(x) for x in cargs), stream_)
        elif kind in ("block_hist", "plane_dct_mm", "pack_emissions", "histogram", "plane_dct"):
            cargs, fills = prepared[k]
            for t in fills:
                t.zero_()
            err = getattr(lib, entry)(*(_arg(x) for x in cargs), stream_)
        else:
            scan, stride, lpm, codes, lens, n_words, valid = args[k]
            words, total, scratch, fill = prepared[k]
            fill.zero_()
            head = (scan.data_ptr(),) + ((int(scan.shape[0]),) if kind == "scan_pack_slab" else ())
            err = getattr(lib, entry)(*head, int(scan.shape[-2]), stride, lpm, codes.data_ptr(),
                                      lens.data_ptr(), _ptr(valid), *(s.data_ptr() for s in scratch),
                                      words.data_ptr(), n_words, total.data_ptr(), stream_)
        build.check(err, entry)

    def run() -> None:
        for k in range(len(args)):
            one(k)

    return run, [lambda k=k: one(k) for k in range(len(args))], outs


def plain(kind: str, args: list) -> list:
    from ..bitstream.device_pack import pack_scan_plain, pack_scan_slab_plain, pack_to_words
    from ..ops.block_hist import block_histograms_plain
    from ..ops.fused import fused_reference
    from ..ops.fused_phase1 import fused_phase1_reference
    from ..ops.histogram import histogram_grouped_plain
    from ..ops.lookup import table_lookup_grouped_plain
    from ..ops.mxu_dct import mxu_dct_reference
    from ..pipeline import phase1_zigzag_blocks, plane_dct_quant

    if kind == "dct":
        return [fused_reference(a, b) for a, b, _ in args]
    if kind == "lookup":
        return [table_lookup_grouped_plain(a, b) for a, b, _ in args]
    if kind == "phase1":
        return [list(phase1_zigzag_blocks(*call)) for call in args]
    if kind == "phase1_mm":
        return [list(fused_phase1_reference(*call)) for call in args]
    if kind == "block_hist":
        return [list(block_histograms_plain(torch.cat(call))) for call in args]
    if kind == "plane_dct_mm":
        return [mxu_dct_reference(*call) for call in args]
    if kind == "plane_dct":
        return [plane_dct_quant(*call) for call in args]
    if kind == "histogram":
        return [histogram_grouped_plain(*call) for call in args]
    if kind == "pack_emissions":
        return [list(pack_to_words(*call)) for call in args]
    fn = pack_scan_slab_plain if kind == "scan_pack_slab" else pack_scan_plain
    return [list(fn(*call[:6], valid=call[6])) for call in args]


def library(kind: str, args: list):
    """One PyTorch call per captured call computing the same function
    (torch.matmul by M without the rounding, TF32 off; torch.gather;
    torch.einsum C X C^T without the division and rounding; torch.bincount
    with float32 weights on group-offset symbols, as chip_smoke.py times
    it), or None where no PyTorch call does."""
    if kind == "dct":
        flat = [(a.reshape(-1, 64), b) for a, b, _ in args]
        return lambda: [torch.matmul(a, b) for a, b in flat]
    if kind == "lookup":
        gathers = [(b, a.to(torch.int64)) for a, b, _ in args]
        return lambda: [torch.gather(t, 1, s) for t, s in gathers]
    if kind == "histogram":
        flat = [((s + torch.arange(s.shape[0], device=s.device)[:, None] * n).reshape(-1),
                 w.reshape(-1).to(torch.float32), s.shape[0] * n) for s, w, n in args]
        return lambda: [torch.bincount(s, weights=w, minlength=m) for s, w, m in flat]
    if kind in ("plane_dct_mm", "plane_dct"):
        from ..ops.dct import dct_matrix

        c = torch.from_numpy(dct_matrix()).to(args[0][0].device)
        groups = [p.reshape(p.shape[0] // 8, 8, p.shape[1] // 8, 8) for p, _ in args]
        return lambda: [torch.einsum("vy,aybx,ux->avbu", c, x, c) for x in groups]
    return None


def _flat(x) -> list[torch.Tensor]:
    return [t.reshape(-1) for t in (x if isinstance(x, (list, tuple)) else [x])]


def outputs_equal(got, want) -> bool:
    got, want = _flat(got), _flat(want)
    return len(got) == len(want) and all(torch.equal(a.to(b.dtype), b) for a, b in zip(got, want))


def report_mismatch(what: str, got, want) -> None:
    """Where and by how much an output differs from the plain version's."""
    for i, (g, w) in enumerate(zip(_flat(got), _flat(want))):
        diff = g.to(torch.int64) - w.to(torch.int64)
        if not diff.ne(0).any():
            continue
        idx = diff.ne(0).nonzero()[:, 0]
        first = int(idx[0])
        print(json.dumps({"mismatch": what, "output": i, "values": int(idx.numel()), "of": int(g.numel()),
                          "max_abs": int(diff.abs().max()), "first": first,
                          "got": g[first : first + 8].tolist(), "want": w[first : first + 8].tolist()}),
              flush=True)


def clock_under_load(fn, seconds: float = 1.0) -> dict:
    """Median SM clock (MHz) and power draw (W) that nvidia-smi reads every
    100 ms while fn runs back to back for about `seconds`."""
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, text=True)
    try:
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=10)
    rows = [[float(v) for v in line.split(",")] for line in out.strip().splitlines() if line.strip()]
    return {"sm_clock_mhz": statistics.median(r[0] for r in rows),
            "power_w": statistics.median(r[1] for r in rows), "samples": len(rows)}


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def split_times(csrc: Path, inputs: dict, lib_all) -> dict:
    """ms of each launch of csrc's scan pack alone (three-launch; for the
    one launch, with the zero fill of its look-back state), of the zero
    fills alone and of the whole call; of csrc's phase-1 kernels; and of
    csrc's block-histogram launches alone (luma; chroma), a one-segment
    call's two zero fills and the torch.cat of Cb and Cr, and the whole
    pair of calls; of the plane DCTs' and the weighted histogram's calls
    (dct_split, weighted_split); on the captured inputs; lib_all is
    csrc's full build."""
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    out = {}
    for name, (kind, calls) in inputs.items():
        conv = convention(csrc, kind)
        if kind in ("phase1", "phase1_mm"):
            out[name] = {f"{kind} kernel": device_ms(runner(lib_all, kind, calls, conv)[0])}
            continue
        if kind == "block_hist":
            out[name] = hist_split(lib_all, calls, conv)
            continue
        if kind in ("plane_dct_mm", "plane_dct"):
            out[name] = dct_split(csrc, lib_all, kind, calls, conv)
            continue
        if kind == "histogram":
            out[name] = weighted_split(lib_all, calls, conv)
            continue
        if kind == "pack_emissions":
            out[name] = emission_split(lib_all, calls, conv, csrc == build.CSRC)
            continue
        if not kind.startswith("scan_pack"):
            continue
        lib = build_split(csrc) if not conv else None
        scan, stride, lpm, codes, lens, n_words, valid = calls[0]
        words, total, scratch, fill = _pack_buffers(calls[0], conv, kind)
        b, n = (int(scan.shape[0]), int(scan.shape[1])) if kind == "scan_pack_slab" else (1, int(scan.shape[0]))
        ptrs = (scan.data_ptr(), b, n, stride, lpm, codes.data_ptr(), lens.data_ptr(), _ptr(valid))
        if not conv:
            block_bits, sums, base = scratch
            launches = {
                "bits_kernel": lambda: lib.split_bits(*ptrs, block_bits.data_ptr(), sums.data_ptr(), stream()),
                "chunk_scan_kernel": lambda: lib.split_scan(sums.data_ptr(), b, int(sums.shape[1]),
                                                            base.data_ptr(), total.data_ptr(), stream()),
                "emit_kernel": lambda: lib.split_emit(*ptrs, block_bits.data_ptr(), base.data_ptr(),
                                                      words.data_ptr(), n_words, stream()),
            }
        else:
            (state,) = scratch
            head = ptrs if kind == "scan_pack_slab" else ptrs[:1] + ptrs[2:]
            entry = getattr(lib_all, ENTRY_POINTS[kind])

            def pack():
                state.zero_()
                return entry(*head, state.data_ptr(), words.data_ptr(), n_words, total.data_ptr(),
                             stream())

            launches = {"state zero fill + pack_kernel": pack}
        for label, fn in launches.items():  # in order, so that each has its inputs
            build.check(fn(), label)
        torch.cuda.synchronize()
        t = {label: device_ms(lambda fn=fn: build.check(fn(), label)) for label, fn in launches.items()}
        if conv:
            t["state zero fill"] = device_ms(scratch[0].zero_)
        t["torch.zeros(n_words)"] = device_ms(
            lambda: torch.zeros(words.shape, dtype=words.dtype, device=words.device))
        t["the wrapper's zero fill"] = device_ms(fill.zero_)
        t["whole call (zero fills + launches)"] = device_ms(runner(lib_all, kind, calls, conv)[0])
        t["n_words"] = int(words.numel())
        out[name] = t
    return out


def dct_split(csrc: Path, lib, kind: str, calls: list, conv: int) -> dict:
    """ms of each plane-DCT launch of `kind` alone (labelled by its plane's
    shape) and of the pair; for a shared-memory-tile build (conv 0), also
    of its loads alone and its loads with its first pass (the matmul's
    column pass, the Arai row pass), per launch and for the pair; and of a
    torch conversion of the two planes to int16, which moves the same
    bytes."""
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    run, singles, _ = runner(lib, kind, calls, conv)
    labels = [str(list(call[0].shape)) for call in calls]
    t = {}
    if not conv:
        shim = build_stage_split(csrc, kind)
        split = shim.split_mm if kind == "plane_dct_mm" else shim.split_plane
        staged = [_plane_args(call, conv, kind)[0] for call in calls]
        first = "column pass" if kind == "plane_dct_mm" else "row pass"

        def stage(more: int, which: list):
            def fn():
                for plane, h, w, c, q, o in which:
                    build.check(split(plane.data_ptr(), h, w, c.data_ptr(), q.data_ptr(),
                                      o.data_ptr(), more, 0, stream()), "split stage")
            return fn

        for cols, label in ((0, "loads"), (1, f"loads + {first}")):
            for one, part in zip(staged, labels):
                t[f"{part}: {label}"] = device_ms(stage(cols, [one]))
            t[f"pair: {label}"] = device_ms(stage(cols, staged))
    for fn, part in zip(singles, labels):
        t[f"{part}: whole kernel"] = device_ms(fn)
    t["pair: whole kernels"] = device_ms(run)
    # a yardstick of the card's streaming rate for the same bytes: one
    # PyTorch conversion of each plane to int16 (4 bytes read, 2 written)
    t["pair: torch .to(int16) of the planes"] = device_ms(lambda: [c[0].to(torch.int16) for c in calls])
    return t


def emission_split(lib, calls: list, conv: int, this: bool) -> dict:
    """ms of the wrapper's torch.zeros of the word buffer, of the kernel
    alone (on a buffer zeroed once: every launch ORs the same words), of
    the zero fill with the kernel, and, for this checkout's build, of the
    wrapper pack_emission_words as the paths call it."""
    from ..bitstream.emission_pack import pack_emission_words

    (call,) = calls
    cargs, words, _ = _emission_args(call, conv)
    entry = lib.dmmt_pack_emissions

    def kernel():
        build.check(entry(*(_arg(x) for x in cargs), torch.cuda.current_stream().cuda_stream),
                    "dmmt_pack_emissions")

    t = {"torch.zeros(n_words)": device_ms(
            lambda: torch.zeros(words.shape, dtype=words.dtype, device=words.device)),
         "kernel alone": device_ms(kernel),
         "zero fill + kernel": device_ms(runner(lib, "pack_emissions", calls, conv)[0])}
    if this:
        t["pack_emission_words (the wrapper)"] = device_ms(lambda: pack_emission_words(*call))
    t["n_blocks"], t["n_words"] = int(call[0].shape[0]), int(call[4])
    t["live slots"] = int((call[1] > 0).sum())
    return t


def weighted_split(lib, calls: list, conv: int) -> dict:
    """ms of each weighted-histogram call alone (a build without state on
    an output zeroed once, outside the timing; labelled by its shape and
    bins), of the wrapper's torch.zeros of each output (conv 0), of each
    call as the wrapper runs it, and of all of them."""
    run, singles, _ = runner(lib, "histogram", calls, conv)
    t = {}
    for call, fn in zip(calls, singles):
        sym, n_bins = call[0], call[2]
        label = f"{list(sym.shape)} x {n_bins} bins"
        cargs, fills, _ = _weighted_hist_args(call, conv)
        for x in fills:
            x.zero_()
        t[f"{label}: kernel alone"] = device_ms(lambda cargs=cargs: build.check(lib.dmmt_histogram_grouped(
            *(_arg(x) for x in cargs), torch.cuda.current_stream().cuda_stream), "dmmt_histogram_grouped"))
        if not conv:
            t[f"{label}: torch.zeros"] = device_ms(
                lambda shape=fills[0].shape: torch.zeros(shape, dtype=torch.int32, device=sym.device))
        t[f"{label}: as the wrapper runs it"] = device_ms(fn)
    t["all calls as the wrappers run them"] = device_ms(run)
    return t


def hist_split(lib, calls: list, conv: int) -> dict:
    """ms of each block-histogram launch alone (a one-segment build's on
    histograms zeroed once, outside the timing), of a one-segment call's
    two zero fills and of the torch.cat it needs for Cb and Cr, and of the
    whole pair of calls as the wrappers run them."""
    run, singles, _ = runner(lib, "block_hist", calls, conv)
    t = {}
    for call, label in zip(calls, ("luma", "chroma")):
        cargs, fills, _ = _hist_buffers(call, conv)
        for x in fills:
            x.zero_()
        t[f"{label} launch ({len(call)} segment{'s' * (len(call) > 1)} as called)"] = device_ms(
            lambda cargs=cargs: build.check(lib.dmmt_block_hist(
                *(_arg(x) for x in cargs), torch.cuda.current_stream().cuda_stream), "dmmt_block_hist"))
        if len(call) > 1:
            t["torch.cat([cb, cr])"] = device_ms(lambda call=call: torch.cat(call))
    if not conv:
        dev = calls[0][0].device
        t["two torch.zeros (16, 256)"] = device_ms(
            lambda: [torch.zeros(n, dtype=torch.int32, device=dev) for n in (16, 256)])
    for k, fn in enumerate(singles):
        t[f"call {k} as the wrapper runs it (fills + launch)"] = device_ms(fn)
    t["whole pair of calls (fills + launches; no cat)"] = device_ms(run)
    return t


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other_csrc", type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--kinds", default=",".join(KINDS))
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--split-this", action="store_true")
    args = ap.parse_args(argv)
    kinds = [k for k in args.kinds.split(",") if k]
    if not set(kinds) <= set(KINDS):
        ap.error(f"--kinds: choose from {KINDS}")
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO / "tests"))
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    csrc = args.other_csrc.resolve()
    libs = {"other": build_other(csrc, kinds), "this": build.load()}
    conv = {label: {k: convention(c, k) for k in KINDS}
            for label, c in (("other", csrc), ("this", build.CSRC))}
    order = ["other", "this", "this", "other"] * args.rounds
    times: dict = {}
    bad: list[str] = []
    under_load: dict = {}
    inputs = capture_inputs(dev, kinds)
    if args.split:
        print(json.dumps({"split": split_times(csrc, inputs, libs["other"]),
                          "device": torch.cuda.get_device_name(0)}), flush=True)
    if args.split_this:
        print(json.dumps({"split this": split_times(build.CSRC, inputs, libs["this"]),
                          "device": torch.cuda.get_device_name(0)}), flush=True)
    for name, (kind, calls) in inputs.items():
        want = plain(kind, calls)
        refs = {}
        if kind in ("dct", "lookup"):
            refs["the encode's kernel"] = [c[2] for c in calls]
        runs, singles = {}, {}
        for label, lib in libs.items():
            run, singles[label], outs = runner(lib, kind, calls, conv[label][kind])
            run()
            torch.cuda.synchronize()
            refs[f"the {label} build"] = outs
            runs[label] = run
        for label, outs in refs.items():
            for k, (o, w) in enumerate(zip(outs, want)):
                if not outputs_equal(o, w):
                    bad.append(f"{name} call {k}: {label} != plain")
                    report_mismatch(bad[-1], o, w)
        for i, label in enumerate(order):
            ms = device_ms(runs[label])
            times.setdefault(name, {}).setdefault(label, []).append(ms)
            print(json.dumps({"input": name, "build": label, "round": i, "ms": ms}), flush=True)
        lib_fn = library(kind, calls)
        if lib_fn is not None:
            times[name]["library"] = [device_ms(lib_fn)]
        under_load[name] = clock_under_load(runs["this"])
        if len(calls) > 1:
            for label, fns in singles.items():
                for k, fn in enumerate(fns):
                    times[name].setdefault(f"{label}, call {k} alone", []).append(device_ms(fn))
    # the card's float32 rate as cuBLAS reaches it: one 8192^3 product, TF32 off
    a = torch.randn(8192, 8192, device=dev)
    sgemm_tflops = 2 * 8192 ** 3 / device_ms(lambda: torch.matmul(a, a)) / 1e9
    del a
    print(json.dumps({"median_ms": {n: {k: statistics.median(v) for k, v in t.items()}
                                    for n, t in times.items()},
                      "this build under load": under_load,
                      "sgemm_8192_tflops": sgemm_tflops,
                      "shapes": {n: [list(c[0].shape) for c in cs] for n, (_, cs) in inputs.items()},
                      "device": torch.cuda.get_device_name(0)}))
    print(gpu_line())
    if bad:
        print("\n".join(bad), file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
