"""Kernels of this checkout against another build of the same C entry
points, on one card, in one process.

    python -m dmmt_jpeg_encoder_tpu_torch.tools.kernel_ab OTHER_CSRC [--rounds N]
        [--kinds dct,lookup,phase1,phase1_mm,block_hist,scan_pack,scan_pack_slab]
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
  buffer, as the wrapper runs it.

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
from host memory (copied into the launch's parameters). Rounds run in
the order other, this, this, other; every time is
tools/timing.device_ms of one call list, beside the library call that
computes the same function where there is one (torch.matmul by M,
torch.gather). Prints one JSON line per (input, build, round), one summary
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
torch.cat of Cb and Cr that a one-segment chroma call needs; with
--split-this the same for this checkout's; one JSON line each. Needs a
card and nvcc.
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
KINDS = ("dct", "lookup", "phase1", "phase1_mm", "block_hist", "scan_pack", "scan_pack_slab")
SOURCES = {"dct": "block_dct.cu", "lookup": "table_lookup.cu", "phase1": "phase1.cu",
           "phase1_mm": "fused_phase1.cu", "block_hist": "block_hist.cu",
           "scan_pack": "scan_pack.cu", "scan_pack_slab": "scan_pack.cu"}
ENTRY_POINTS = {"dct": "dmmt_block_dct_zz", "lookup": "dmmt_table_lookup_grouped",
                "phase1": "dmmt_phase1", "phase1_mm": "dmmt_phase1_mm",
                "block_hist": "dmmt_block_hist", "scan_pack": "dmmt_scan_pack",
                "scan_pack_slab": "dmmt_scan_pack_slab"}
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
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
    Block histogram: 0 for one segment, 1 for two. Fused matmul phase 1: 0
    for constants in device memory, 1 for host memory. Else 0."""
    if kind.startswith("scan_pack"):
        if three_launch(csrc):
            return 0
        return int(re.search(r"constexpr int TILE = (\d+);", (csrc / "scan_pack.cu").read_text())[1])
    if kind == "block_hist":
        return int("long long n_blocks, long long n_valid" not in (csrc / "block_hist.cu").read_text())
    if kind == "phase1_mm":
        return int("c_host" in (csrc / "fused_phase1.cu").read_text())
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
    return _bind(lib, sigs)


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
    from .. import onedispatch
    from ..bitstream import device_pack
    from ..ops import block_hist, fused, fused_arai, fused_phase1
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
        def wrapped(rgb, maxval, luma_q, chroma_q, preset):
            calls.append((_contig(rgb), maxval, _contig(luma_q), _contig(chroma_q), preset))
            return real(rgb, maxval, luma_q, chroma_q, preset)
        return wrapped

    def grab_hist(real):
        def wrapped(coeffs_zz, n_valid=None):
            segs = coeffs_zz if isinstance(coeffs_zz, (tuple, list)) else (coeffs_zz,)
            hist_calls.append(tuple(_contig(x) for x in segs))
            return real(coeffs_zz, n_valid)
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
    inputs = {}
    if "dct" in kinds:
        with _patched(fused, "fused_dct_quantize_zigzag", grab_dct):
            port.encode_array(px, 255, dataclasses.replace(cfg, dct_variant=port.DCTVariant.FUSED),
                              device=dev)
        inputs["block_dct_zz 4k_p420 FUSED (luma, Cb, Cr)"] = ("dct", calls[:])
        calls.clear()
    if "lookup" in kinds:
        os.environ["DMMT_NO_FUSED_PACK"] = "1"
        try:
            with _patched(device_pack, "table_lookup_grouped", grab_lookup):
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
            port.encode_array(px, 255, cfg, device=dev)
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
                port.encode_array(px, 255, cfg, device=dev)
        finally:
            os.environ.pop("DMMT_P1")
        inputs["phase1_mm 4k_p420 (uint8 P420, DMMT_P1=fused1)"] = ("phase1_mm", calls[:])
        calls.clear()
    if "scan_pack_slab" in kinds:
        os.environ["DMMT_SLAB_ONEPACK"] = "1"
        try:
            with _patched(onedispatch, "fused_pack_words_slab", grab_pack):
                port.encode_batch(frames, fb["maxval"], cfg, device=dev)
        finally:
            os.environ.pop("DMMT_SLAB_ONEPACK")
        (slab,) = calls
        calls.clear()
        b, n, stride = int(slab[0].shape[0]), int(slab[0].shape[1]), slab[1]
        inputs[f"scan_pack_slab batch_1080p_p420 x {b}"] = ("scan_pack_slab", [(*slab, None)])
        inputs[f"scan_pack_slab batch_1080p_p420 x {b} valid prefixes"] = (
            "scan_pack_slab", [(*slab, _prefix_mask(n, stride, b, dev))])
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
        elif kind == "block_hist":
            cargs, fills = prepared[k]
            for t in fills:
                t.zero_()
            err = lib.dmmt_block_hist(*(_arg(x) for x in cargs), stream_)
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
    from ..bitstream.device_pack import pack_scan_plain, pack_scan_slab_plain
    from ..ops.block_hist import block_histograms_plain
    from ..ops.fused import fused_reference
    from ..ops.fused_phase1 import fused_phase1_reference
    from ..ops.lookup import table_lookup_grouped_plain
    from ..pipeline import phase1_zigzag_blocks

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
    fn = pack_scan_slab_plain if kind == "scan_pack_slab" else pack_scan_plain
    return [list(fn(*call[:6], valid=call[6])) for call in args]


def library(kind: str, args: list):
    """One PyTorch call per captured call computing the same function
    (torch.matmul by M without the rounding, TF32 off; torch.gather), or
    None where no PyTorch call does."""
    if kind == "dct":
        flat = [(a.reshape(-1, 64), b) for a, b, _ in args]
        return lambda: [torch.matmul(a, b) for a, b in flat]
    if kind == "lookup":
        gathers = [(b, a.to(torch.int64)) for a, b, _ in args]
        return lambda: [torch.gather(t, 1, s) for t, s in gathers]
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
    pair of calls; on the captured inputs; lib_all is csrc's full build."""
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
