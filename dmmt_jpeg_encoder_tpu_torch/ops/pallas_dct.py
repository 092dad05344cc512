"""Plane DCT kernel wrapper (DMMT_P1=pallas): Arai DCT + quantize of one
float32 plane.

Counterpart of dmmt_jpeg_encoder_tpu.ops.pallas_dct.plane_dct_quant. Its
bits equal the default `plane` phase 1's DCT stage, so its plain version
is pipeline.plane_dct_quant. The CUDA kernel is csrc/plane_dct.cu (two
threads per 8x8 group, the Arai constants as a launch parameter passed
from host memory, the table read as the route passes it: uint8, or
float32).

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from ..kernels import build
from ..pipeline import plane_dct_quant as plane_dct_quant_plain
from .fused_arai import kernel_constants

# the kernel's constants, in host memory: copied into each launch's parameters
_CONSTANTS = kernel_constants()


def check_plane(plane: torch.Tensor, what: str) -> None:
    """Raise unless `plane` is a float32 [H, W] CUDA tensor, H and W
    multiples of 8."""
    if plane.device.type != "cuda":
        raise ValueError(f"{what} kernel needs a CUDA tensor, got {plane.device}")
    if plane.dtype != torch.float32 or plane.ndim != 2 or plane.shape[0] % 8 or plane.shape[1] % 8:
        raise ValueError(f"expected a float32 [8a, 8b] plane, got {plane.dtype} {tuple(plane.shape)}")


def plane_dct_quant(plane: torch.Tensor, qtable: torch.Tensor) -> torch.Tensor:
    """float32 [H, W] plane (H, W multiples of 8) + raster [64] table ->
    int16 [H, W] quantized coefficient plane (v = row % 8, u = col % 8)."""
    if plane.device.type == "cpu":
        return plane_dct_quant_plain(plane, qtable)
    check_plane(plane, "plane_dct")
    plane = plane.contiguous()
    dev = plane.device
    out = torch.empty(plane.shape, dtype=torch.int16, device=dev)
    # the kernel reads uint8 tables (the encoder's) as they are
    q = qtable.to(device=dev, dtype=torch.uint8 if qtable.dtype == torch.uint8 else torch.float32)
    q = q.contiguous()
    err = build.load().dmmt_plane_dct(
        plane.data_ptr(), int(plane.shape[0]), int(plane.shape[1]), _CONSTANTS.ctypes.data,
        q.data_ptr(), int(q.dtype == torch.uint8), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(err, "dmmt_plane_dct")
    build.LAUNCHES["plane_dct"] += 1
    return out
