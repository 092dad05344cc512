"""Image geometry (torch): MCU padding, chroma subsampling, blockize,
P420 entangle.

Counterpart of dmmt_jpeg_encoder_tpu.ops.geometry for the default
presets and its arbitrary-rate `subsample_generalized`, and of the
pair-sum subsample of its ops/fused_phase1. The
Average subsample keeps the reference's summation order
(reference: src/image/subsampling.rs:108-122): a 2x2 cell sums as
((tl + bl) + tr) + br, then / 4.0; a P422 pair as (l + r) / 2.0.

`subsample_scaled` takes the chroma plane BEFORE its scale by 255
(ops/color.chroma_sums), because the JAX reference, as XLA's CPU backend
compiles it, fuses that scale into the cell adds (see ops/fma.py):

    P420: fma(br, 255, fma(tr, 255, fma(tl, 255, bl * 255))) / 4
    P422: fma(l, 255, r * 255) / 2
    P444: sum * 255
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..config import ChromaSubsamplingPreset, SubsamplingMethod
from ..utils.device import device_constant
from .color import SCALE, f32
from .fma import fma


def padded_size(height: int, width: int, preset: ChromaSubsamplingPreset) -> tuple[int, int]:
    """Pad-to multiples of (v_rate*8, h_rate*8)
    (reference: src/...jpeg/transformer.rs:48-51, padder.rs:12-20)."""
    mh, mw = preset.mcu_height, preset.mcu_width
    return (-(-height // mh) * mh, -(-width // mw) * mw)


def pad_to_mcu_multiple(rgb: torch.Tensor, preset: ChromaSubsamplingPreset) -> torch.Tensor:
    """Pad [H, W, 3] with black (0.0) on the right/bottom
    (reference: src/image/writer/jpeg/padder.rs:12-42)."""
    h, w = rgb.shape[0], rgb.shape[1]
    ph, pw = padded_size(h, w, preset)
    if (ph, pw) == (h, w):
        return rgb
    return F.pad(rgb, (0, 0, 0, pw - w, 0, ph - h))


def subsample_scaled(chroma_sum: torch.Tensor, preset: ChromaSubsamplingPreset) -> torch.Tensor:
    """MCU-padded pre-scale chroma plane [H, W] -> subsampled chroma plane
    (see the module docstring for the arithmetic)."""
    s = f32(SCALE)
    if preset is ChromaSubsamplingPreset.P444:
        return chroma_sum * s
    if preset is ChromaSubsamplingPreset.P422:
        left, right = chroma_sum[:, 0::2], chroma_sum[:, 1::2]
        return fma(left, s, right * s) / f32(2.0)
    tl, tr = chroma_sum[0::2, 0::2], chroma_sum[0::2, 1::2]
    bl, br = chroma_sum[1::2, 0::2], chroma_sum[1::2, 1::2]
    return fma(br, s, fma(tr, s, fma(tl, s, bl * s))) / f32(4.0)


def subsample_pairs_scaled(chroma_sum: torch.Tensor, preset: ChromaSubsamplingPreset) -> torch.Tensor:
    """The DMMT_P1=fused1 subsample of a pre-scale chroma plane: vertical
    pairs first, then horizontal pairs, then one scale by 1 / (h * v),
    with the scale by 255 fused into the first pair add as XLA compiles
    the JAX reference (fused_phase1_reference):

        P420: (fma(tl, 255, bl * 255) + fma(tr, 255, br * 255)) * 0.25
        P422: fma(l, 255, r * 255) * 0.5
        P444: sum * 255
    """
    s = f32(SCALE)
    if preset is ChromaSubsamplingPreset.P444:
        return chroma_sum * s
    if preset is ChromaSubsamplingPreset.P422:
        pairs = fma(chroma_sum[:, 0::2], s, chroma_sum[:, 1::2] * s)
    else:
        cols = fma(chroma_sum[0::2], s, chroma_sum[1::2] * s)
        pairs = cols[:, 0::2] + cols[:, 1::2]
    return pairs * f32(1.0 / (preset.horizontal_rate * preset.vertical_rate))


def subsample_generalized(
    chan: torch.Tensor,
    horizontal_rate: int,
    vertical_rate: int,
    method: SubsamplingMethod,
) -> torch.Tensor:
    """Arbitrary-rate subsampling of a float32 [H, W] plane with the
    reference's border rule (reference: src/image/subsampling.rs:81-135):
    the output is [ceil(H / v), ceil(W / h)], a partial trailing cell still
    gives one sample; Average sums the h x v cell column-major (x outer, y
    inner) with coordinates clamped to the last row and column, and divides
    by h * v (clamped duplicates included). The encode's presets take
    subsample_scaled; this is the library-level form (tests only)."""
    hr, vr = int(horizontal_rate), int(vertical_rate)
    if hr < 1 or vr < 1:
        raise ValueError("subsampling rates must be >= 1")
    h, w = chan.shape
    if method is SubsamplingMethod.SKIP:
        return chan[::vr, ::hr]
    rows = torch.arange(-(-h // vr), device=chan.device) * vr
    cols = torch.arange(-(-w // hr), device=chan.device) * hr
    total = None
    for x in range(hr):
        for y in range(vr):
            s = chan[(rows + y).clamp(max=h - 1)][:, (cols + x).clamp(max=w - 1)]
            total = s if total is None else total + s
    return total / device_constant(np.array(hr * vr, dtype=np.float32), chan.device)


def blockize(plane: torch.Tensor) -> torch.Tensor:
    """[H, W] -> [N, 8, 8] blocks in raster block order."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).permute(0, 2, 1, 3).reshape(-1, 8, 8)


def entangled_blockize_p420(plane: torch.Tensor) -> torch.Tensor:
    """[H, W] -> [N, 8, 8] blocks in P420 MCU (quad) order: TL, TR, BL, BR."""
    h, w = plane.shape
    return (plane.reshape(h // 16, 2, 8, w // 16, 2, 8)
            .permute(0, 3, 1, 4, 2, 5).reshape(-1, 8, 8))


def entangle_quads(blocks: torch.Tensor, block_rows: int, block_cols: int) -> torch.Tensor:
    """Raster-ordered [A*B, 64] blocks -> P420 MCU (quad) order: TL, TR,
    BL, BR per 2x2 block quad (reference: block_entangler.rs:69-91)."""
    a, b = block_rows, block_cols
    return (
        blocks.reshape(a // 2, 2, b // 2, 2, 64)
        .permute(0, 2, 1, 3, 4)
        .reshape(-1, 64)
    )
