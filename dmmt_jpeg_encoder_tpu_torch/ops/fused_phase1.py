"""Fused phase-1 kernel wrapper (DMMT_P1=fused1): integer RGB -> int16
quantized coefficient planes in one launch.

Counterpart of dmmt_jpeg_encoder_tpu.ops.fused_phase1.fused_phase1. Per
pixel: normalize by x * (1 / maxval) (one float32 divide, then
multiplies: not the plane path's true division), YCbCr with the color
sums of ops/color, the pair-sum subsample of
geometry.subsample_pairs_scaled, then the matmul DCT of ops/mxu_dct and
quantize. Not Arai-bit-exact: the route is opt-in, as in the JAX package.
The CUDA kernel is csrc/fused_phase1.cu; the plain version is
`fused_phase1_reference`. `split` selects DMMT_P1_PREC=high's DCT
contractions (ops/mxu_dct.dot_p1) on all three planes: the kernel's split
arm, and the plain version's. The JAX package's tile width knob
DMMT_FUSED1_TILEW shapes only its TPU grid (outputs do not depend on it)
and has no counterpart here.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..config import ChromaSubsamplingPreset
from ..kernels import build
from .color import chroma_sums, f32, luma
from .fused_arai import kernel_constants
from .geometry import padded_size, subsample_pairs_scaled
from .mxu_dct import DCT_MATRIX, DCT_SPLIT, mxu_dct_reference


def fused_phase1_reference(
    rgb: torch.Tensor,
    maxval: int,
    luma_q: torch.Tensor,
    chroma_q: torch.Tensor,
    preset: ChromaSubsamplingPreset,
    split: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: integer RGB [H, W, 3] (unpadded) -> (luma int16
    [PH, PW], cb and cr int16 [PH / v, PW / h]) coefficient planes of the
    image padded black to its MCU multiple."""
    h, w = int(rgb.shape[0]), int(rgb.shape[1])
    ph, pw = padded_size(h, w, preset)
    inv = f32(np.float32(1.0) / np.float32(maxval))
    norm = F.pad(rgb.to(torch.float32) * inv, (0, 0, 0, pw - w, 0, ph - h))
    r, g, b = norm.unbind(-1)
    return (mxu_dct_reference(luma(r, g, b), luma_q, split),
            *(mxu_dct_reference(subsample_pairs_scaled(c, preset), chroma_q, split)
              for c in chroma_sums(r, g, b)))


def fused_phase1(
    rgb: torch.Tensor,
    maxval: int,
    luma_q: torch.Tensor,
    chroma_q: torch.Tensor,
    preset: ChromaSubsamplingPreset,
    split: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """uint8/uint16 RGB [H, W, 3] (unpadded) + raster [64] tables -> the
    coefficient planes of fused_phase1_reference."""
    if rgb.device.type == "cpu":
        return fused_phase1_reference(rgb, maxval, luma_q, chroma_q, preset, split)
    if rgb.device.type != "cuda":
        raise ValueError(f"phase1_mm kernel needs a CUDA tensor, got {rgb.device}")
    if rgb.dtype not in (torch.uint8, torch.uint16) or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected uint8/uint16 [H, W, 3] pixels, got {rgb.dtype} {tuple(rgb.shape)}")
    rgb = rgb.contiguous()
    dev = rgb.device
    h, w = int(rgb.shape[0]), int(rgb.shape[1])
    ph, pw = padded_size(h, w, preset)
    hr, vr = preset.horizontal_rate, preset.vertical_rate
    out_y = torch.empty((ph, pw), dtype=torch.int16, device=dev)
    out_cb = torch.empty((ph // vr, pw // hr), dtype=torch.int16, device=dev)
    out_cr = torch.empty_like(out_cb)
    # host arrays: the C entry point copies them into the launch's parameters
    consts = kernel_constants()
    qy = luma_q.to(device=dev, dtype=torch.float32).contiguous()
    qc = chroma_q.to(device=dev, dtype=torch.float32).contiguous()
    args = (rgb.data_ptr(), rgb.element_size(), h, w, hr, vr, float(maxval), consts.ctypes.data)
    outs = (qy.data_ptr(), qc.data_ptr(), out_y.data_ptr(), out_cb.data_ptr(), out_cr.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if split:
        err = build.load().dmmt_phase1_mm_split(*args, *(t.ctypes.data for t in DCT_SPLIT), *outs)
        build.check(err, "dmmt_phase1_mm_split")
        build.LAUNCHES["phase1_mm_high"] += 1
    else:
        err = build.load().dmmt_phase1_mm(*args, DCT_MATRIX.ctypes.data, *outs)
        build.check(err, "dmmt_phase1_mm")
        build.LAUNCHES["phase1_mm"] += 1
    return out_y, out_cb, out_cr
