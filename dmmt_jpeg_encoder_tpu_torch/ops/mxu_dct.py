"""Matmul plane DCT kernel wrapper (DMMT_P1=mxu, and the SIMPLE and
SEPARATED DCT variants): C X C^T of every 8x8 group of a float32 plane,
then quantize.

Counterpart of dmmt_jpeg_encoder_tpu.ops.mxu_dct.plane_dct_quant_mxu,
whose TPU kernel multiplies by block-diagonal kron(I, C) matrices on the
MXU. What it computes is an 8-term contraction per output, column pass
first; the JAX reference's bits are those of XLA's CPU backend, whose
summation order ops/dct.contract8 reproduces. Not Arai-bit-exact: the
route is opt-in, as in the JAX package. The CUDA kernel is
csrc/mxu_dct.cu (two threads per 8x8 group, the DCT matrix as a launch
parameter passed from host memory); the plain version is
`mxu_dct_reference`.

DMMT_P1_PREC selects the JAX package's matmul precision of the mxu and
fused1 routes (`check_p1_precision`, called by the phase-1 router).
"highest" (the default) is the full float32 contraction ported here;
"high" (a bf16x3 split of each operand) is not ported (ROADMAP A11) and
raises NotImplementedError; any other value raises ValueError, as in the
JAX package. The DCT variants ignore it, as in the JAX package.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..kernels import build
from .dct import dct_matrix, matmul_dct_pass
from .pallas_dct import check_plane
from .quantize import round_half_away_from_zero


# the kernel's DCT matrix, in host memory: copied into each launch's parameters
_DCT_MATRIX = dct_matrix()


def check_p1_precision() -> None:
    """Raise unless DMMT_P1_PREC asks for the ported precision."""
    v = os.environ.get("DMMT_P1_PREC", "highest")
    if v not in ("high", "highest"):
        raise ValueError(f"DMMT_P1_PREC must be 'high' or 'highest', got {v!r}")
    if v == "high":
        raise NotImplementedError(
            "DMMT_P1_PREC=high (the bf16x3 matmul split) is not ported yet (ROADMAP A11); "
            "the port computes the full float32 contraction (DMMT_P1_PREC=highest)"
        )


def mxu_dct_reference(plane: torch.Tensor, qtable: torch.Tensor) -> torch.Tensor:
    """Plain version: float32 [H, W] plane + raster [64] table -> int16
    [H, W] quantized coefficient plane (v = row % 8, u = col % 8)."""
    h, w = plane.shape
    x = plane.reshape(h // 8, 8, w // 8, 8)
    t = matmul_dct_pass(matmul_dct_pass(x, 1), 3)          # [A, 8v, B, 8u]
    q = qtable.to(device=plane.device, dtype=torch.float32).reshape(8, 8)
    return round_half_away_from_zero(t / q[None, :, None, :]).to(torch.int16).reshape(h, w)


def division_check(device: torch.device, lo: float = 0.0, hi: float = float("inf")) -> tuple[int, int]:
    """The kernel's division by an 8-bit table entry (x * (1 / q) with two
    fma corrections, then its rounding) against __fdiv_rn and dct8.cuh's
    rounding, on the card, for every float32 x with lo <= |x| < hi and
    every q in 1..255: (quotients that differ, coefficients that differ)."""
    lo_bits, hi_bits = (int(np.array(v, np.float32).view(np.uint32)) for v in (lo, hi))
    counts = torch.zeros(2, dtype=torch.int64, device=device)
    err = build.load().dmmt_plane_dct_mm_div_check(
        lo_bits, hi_bits, counts.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    build.check(err, "dmmt_plane_dct_mm_div_check")
    quotients, coefficients = counts.tolist()
    return quotients, coefficients


def plane_dct_quant_mxu(plane: torch.Tensor, qtable: torch.Tensor) -> torch.Tensor:
    """float32 [H, W] plane (H, W multiples of 8) + raster [64] table ->
    int16 [H, W] quantized coefficient plane."""
    if plane.device.type == "cpu":
        return mxu_dct_reference(plane, qtable)
    check_plane(plane, "plane_dct_mm")
    plane = plane.contiguous()
    dev = plane.device
    out = torch.empty(plane.shape, dtype=torch.int16, device=dev)
    # the kernel reads uint8 tables (the encoder's) as they are
    q = qtable.to(device=dev, dtype=torch.uint8 if qtable.dtype == torch.uint8 else torch.float32)
    q = q.contiguous()
    err = build.load().dmmt_plane_dct_mm(
        plane.data_ptr(), int(plane.shape[0]), int(plane.shape[1]), _DCT_MATRIX.ctypes.data,
        q.data_ptr(), int(q.dtype == torch.uint8), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(err, "dmmt_plane_dct_mm")
    build.LAUNCHES["plane_dct_mm"] += 1
    return out
