"""Plain phase 1 in torch: integer RGB -> DPCM'd int16 zigzag blocks.

The counterpart of dmmt_jpeg_encoder_tpu.pipeline in its default `plane`
mode (pipeline.py:159-232, 330-393 there):

    normalize (true f32 division by maxval) -> pad -> RGB->YCbCr ->
    subsample -> Arai DCT on plane layout -> / q -> round half away ->
    int16 -> zigzag -> P420 quad entangle -> DC DPCM

with the float32 roundings of the JAX reference as XLA's CPU backend
compiles it (ops/fma.py). This is the phase-1 kernel's plain version
(ops/fused_arai.py); it runs on whatever device its tensors lie on.
"""

from __future__ import annotations

import torch

from .config import ChromaSubsamplingPreset
from .ops.color import chroma_sums, luma
from .ops.dct import arai_pass
from .ops.geometry import entangle_quads, pad_to_mcu_multiple, subsample_scaled
from .ops.quantize import round_half_away_from_zero
from .tables import ZIGZAG


def plane_to_zigzag_blocks(rounded16: torch.Tensor, entangle: bool) -> torch.Tensor:
    """int16 coefficient PLANE (v = row % 8, u = col % 8) -> int16 [N, 64]
    zigzag blocks, in P420 MCU (quad) order when `entangle`."""
    hh, ww = rounded16.shape
    a, b = hh // 8, ww // 8
    blk = rounded16.reshape(a, 8, b, 8).permute(0, 2, 1, 3).reshape(-1, 64)
    zz = torch.as_tensor(ZIGZAG, dtype=torch.long, device=blk.device)
    out = blk[:, zz]
    return entangle_quads(out, a, b) if entangle else out.contiguous()


def plane_dct_quant(plane: torch.Tensor, qtable: torch.Tensor) -> torch.Tensor:
    """float32 [H, W] plane (H, W multiples of 8) + raster [64] table ->
    int16 [H, W] quantized coefficient plane: Arai rows (along x), then
    columns (along y), / q, round half away from zero."""
    hh, ww = plane.shape
    a, b = hh // 8, ww // 8
    r = arai_pass(plane.reshape(hh, b, 8), dim=-1).reshape(a, 8, b, 8)
    c = arai_pass(r, dim=1)                                  # [A, 8v, B, 8u]
    qv = qtable.to(device=plane.device, dtype=torch.float32).reshape(8, 8)
    scaled = c / qv[None, :, None, :]
    return round_half_away_from_zero(scaled).to(torch.int16).reshape(hh, ww)


def zigzag_blocks_from_planes(
    y: torch.Tensor,
    cb_sum: torch.Tensor,
    cr_sum: torch.Tensor,
    luma_q: torch.Tensor,
    chroma_q: torch.Tensor,
    preset: ChromaSubsamplingPreset,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """MCU-padded luma plane and pre-scale chroma planes
    (ops/color.chroma_sums) -> (luma, cb, cr) int16 [N, 64] zigzag blocks
    BEFORE DC DPCM: luma in MCU order, chroma in raster order."""
    entangle = preset is ChromaSubsamplingPreset.P420
    luma_zz = plane_to_zigzag_blocks(plane_dct_quant(y, luma_q), entangle)
    cbz, crz = (
        plane_to_zigzag_blocks(plane_dct_quant(subsample_scaled(c, preset), chroma_q), False)
        for c in (cb_sum, cr_sum)
    )
    return luma_zz, cbz, crz


def phase1_zigzag_blocks(
    rgb: torch.Tensor,
    maxval: float,
    luma_q: torch.Tensor,
    chroma_q: torch.Tensor,
    preset: ChromaSubsamplingPreset,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Integer RGB [H, W, 3] (unpadded) -> zigzag_blocks_from_planes."""
    mv = torch.tensor(float(maxval), dtype=torch.float32, device=rgb.device)
    norm = pad_to_mcu_multiple(rgb.to(torch.float32) / mv, preset)
    r, g, b = norm.unbind(-1)
    return zigzag_blocks_from_planes(luma(r, g, b), *chroma_sums(r, g, b), luma_q, chroma_q, preset)


def dc_dpcm(blocks: torch.Tensor) -> torch.Tensor:
    """Replace column 0 (DC) of [N, 64] blocks with its delta chain; the
    predictor starts at 0 (categorize.rs:156-161)."""
    return dc_dpcm_per_image(blocks, 1)


def dc_dpcm_per_image(blocks: torch.Tensor, n_images: int) -> torch.Tensor:
    """dc_dpcm with chains that RESET at image boundaries: the block axis of
    a row-stacked slab is the concatenation of n_images equal-length
    per-image sequences, and each image's chain starts from predictor 0 as
    a standalone encode's does (pipeline.dc_dpcm_per_image of the JAX
    package). Computed in int32, then cast back."""
    dc = blocks[:, 0].to(torch.int32).reshape(n_images, -1)
    prev = torch.nn.functional.pad(dc[:, :-1], (1, 0))
    out = blocks.clone()
    out[:, 0] = (dc - prev).reshape(-1).to(blocks.dtype)
    return out
