"""Phase-1 kernel wrapper: integer RGB -> int16 zigzag blocks in one launch.

Counterpart of dmmt_jpeg_encoder_tpu.ops.fused_arai.fused_arai_phase1
(DMMT_P1=fused2), whose bits equal the default `plane` phase 1. The CUDA
kernel (csrc/phase1.cu) also folds in the zigzag reorder and the P420 quad
entangle, so it returns finished blocks. Its plain version is
pipeline.phase1_zigzag_blocks; DC DPCM follows either one
(pipeline.dc_dpcm).

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import ChromaSubsamplingPreset
from ..kernels import build
from ..ops.color import CB_WEIGHTS, CR_WEIGHTS, LEVEL_SHIFT, SCALE, Y_WEIGHTS
from ..ops.dct import A1, A2, A3, A4, A5, S
from ..ops.geometry import padded_size
from ..pipeline import phase1_zigzag_blocks
from ..utils.device import device_constant


def kernel_constants() -> np.ndarray:
    """float32 constants in the order csrc/phase1.cu reads them (K_Y0 ..
    K_S0+7), taken from the torch ops so kernel and plain version use the
    same values."""
    return np.array(
        [*Y_WEIGHTS, LEVEL_SHIFT, SCALE, *CB_WEIGHTS, *CR_WEIGHTS, A1, A2, A3, A4, A5, *S],
        dtype=np.float32,
    )


def fused_arai_phase1(
    rgb: torch.Tensor,
    maxval: int,
    luma_q: torch.Tensor,
    chroma_q: torch.Tensor,
    preset: ChromaSubsamplingPreset,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """uint8/uint16 RGB [H, W, 3] (unpadded) + raster [64] quant tables ->
    (luma, cb, cr) int16 [N, 64] zigzag blocks before DC DPCM: luma in MCU
    order, chroma in raster block order."""
    if rgb.device.type == "cpu":
        return phase1_zigzag_blocks(rgb, maxval, luma_q, chroma_q, preset)
    if rgb.device.type != "cuda":
        raise ValueError(f"phase1 kernel needs a CUDA tensor, got {rgb.device}")
    if rgb.dtype not in (torch.uint8, torch.uint16) or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected uint8/uint16 [H, W, 3] pixels, got {rgb.dtype} {tuple(rgb.shape)}")
    rgb = rgb.contiguous()
    dev = rgb.device
    h, w = int(rgb.shape[0]), int(rgb.shape[1])
    ph, pw = padded_size(h, w, preset)
    hr, vr = preset.horizontal_rate, preset.vertical_rate
    n_mcu = (ph // (8 * vr)) * (pw // (8 * hr))
    out_y = torch.empty((n_mcu * hr * vr, 64), dtype=torch.int16, device=dev)
    out_cb = torch.empty((n_mcu, 64), dtype=torch.int16, device=dev)
    out_cr = torch.empty((n_mcu, 64), dtype=torch.int16, device=dev)
    consts = device_constant(kernel_constants(), dev)
    qy = luma_q.to(device=dev, dtype=torch.float32).contiguous()
    qc = chroma_q.to(device=dev, dtype=torch.float32).contiguous()
    lib = build.load()
    err = lib.dmmt_phase1(
        rgb.data_ptr(), rgb.element_size(), h, w, hr, vr, float(maxval),
        consts.data_ptr(), qy.data_ptr(), qc.data_ptr(),
        out_y.data_ptr(), out_cb.data_ptr(), out_cr.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(err, "dmmt_phase1")
    build.LAUNCHES["phase1"] += 1
    return out_y, out_cb, out_cr
