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
fused1 routes (`check_p1_precision`, read by the phase-1 router, which
passes `split` to the two kernels). "highest" (the default) is the full
float32 contraction above. "high" is the JAX package's bf16x3 split
(`dot_p1`): each operand a = hi(a) + lo(a), hi the bf16 rounding (round to
nearest even) and lo the bf16 rounding of the residual, and a @ b as
hi@hi + (lo@hi + hi@lo), three products of bf16 operands summed in
float32. Its bits are those of XLA's CPU dot of bf16 operands with a
float32 result on a host with AVX512-BF16: VDPBF16PS adds the odd product
of each pair, then the even one, so an 8-term sum is the float32 chain
over terms 1, 0, 3, 2, 5, 4, 7, 6 (`PAIR_ORDER`; every bf16 x bf16
product is exact in float32). Any other value raises ValueError, as in
the JAX package. The DCT variants and the sharded encode do not read it,
as in the JAX package. The kernel's split arm takes C's halves as its
launch parameters (`DCT_SPLIT`) and splits the plane and the column
pass's results itself.

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
DCT_MATRIX = dct_matrix()


def check_p1_precision() -> str:
    """DMMT_P1_PREC ("highest" when unset); ValueError for any value but
    "high" and "highest"."""
    v = os.environ.get("DMMT_P1_PREC", "highest")
    if v not in ("high", "highest"):
        raise ValueError(f"DMMT_P1_PREC must be 'high' or 'highest', got {v!r}")
    return v


def split_bf16(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 x -> (hi, lo) float32 holding bf16 values: hi = bf16(x),
    lo = bf16(x - hi), both rounded to nearest even (x - hi is exact)."""
    hi = x.to(torch.bfloat16).to(torch.float32)
    return hi, (x - hi).to(torch.bfloat16).to(torch.float32)


# the split arm's DCT matrix halves, in host memory like DCT_MATRIX
DCT_SPLIT = tuple(t.numpy() for t in split_bf16(torch.from_numpy(DCT_MATRIX)))

# the order in which XLA's CPU dot of bf16 operands adds the 8 products
# (the module docstring)
PAIR_ORDER = (1, 0, 3, 2, 5, 4, 7, 6)


def dot_bf16_pairs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, 8] @ b [8, N] of float32 holding bf16 values -> float32
    [M, N]: from 0, one float32 add per exact product in PAIR_ORDER."""
    s = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32, device=a.device)
    for n in PAIR_ORDER:
        s = s + a[:, n, None] * b[None, n, :]
    return s


def dot_p1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The JAX package's DMMT_P1_PREC=high contraction of float32 a [M, 8]
    and b [8, N]: hi(a)@hi(b) + (lo(a)@hi(b) + hi(a)@lo(b))."""
    a_hi, a_lo = split_bf16(a)
    b_hi, b_lo = split_bf16(b)
    return dot_bf16_pairs(a_hi, b_hi) + (dot_bf16_pairs(a_lo, b_hi) + dot_bf16_pairs(a_hi, b_lo))


def mxu_dct_reference(plane: torch.Tensor, qtable: torch.Tensor, split: bool = False) -> torch.Tensor:
    """Plain version: float32 [H, W] plane + raster [64] table -> int16
    [H, W] quantized coefficient plane (v = row % 8, u = col % 8); with
    `split`, both passes by dot_p1, as the JAX reference's HIGH arm."""
    h, w = plane.shape
    q = qtable.to(device=plane.device, dtype=torch.float32).reshape(8, 8)
    if split:
        c = torch.from_numpy(DCT_MATRIX).to(plane.device)
        # column pass C @ (8-row groups), then row pass (8-column groups) @ C^T
        xr = plane.reshape(h // 8, 8, w).permute(1, 0, 2).reshape(8, -1)
        t1 = dot_p1(c, xr).reshape(8, h // 8, w).permute(1, 0, 2).reshape(h * (w // 8), 8)
        t = dot_p1(t1, c.T).reshape(h // 8, 8, w // 8, 8)
    else:
        x = plane.reshape(h // 8, 8, w // 8, 8)
        t = matmul_dct_pass(matmul_dct_pass(x, 1), 3)          # [A, 8v, B, 8u]
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


def plane_dct_quant_mxu(plane: torch.Tensor, qtable: torch.Tensor, split: bool = False) -> torch.Tensor:
    """float32 [H, W] plane (H, W multiples of 8) + raster [64] table ->
    int16 [H, W] quantized coefficient plane; `split`: DMMT_P1_PREC=high's
    contractions (the kernel's split arm)."""
    if plane.device.type == "cpu":
        return mxu_dct_reference(plane, qtable, split)
    check_plane(plane, "plane_dct_mm")
    plane = plane.contiguous()
    dev = plane.device
    out = torch.empty(plane.shape, dtype=torch.int16, device=dev)
    # the kernel reads uint8 tables (the encoder's) as they are
    q = qtable.to(device=dev, dtype=torch.uint8 if qtable.dtype == torch.uint8 else torch.float32)
    q = q.contiguous()
    h, w = int(plane.shape[0]), int(plane.shape[1])
    rest = (q.data_ptr(), int(q.dtype == torch.uint8), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if split:
        err = build.load().dmmt_plane_dct_mm_split(
            plane.data_ptr(), h, w, *(t.ctypes.data for t in DCT_SPLIT), *rest)
        build.check(err, "dmmt_plane_dct_mm_split")
        build.LAUNCHES["plane_dct_mm_high"] += 1
    else:
        err = build.load().dmmt_plane_dct_mm(plane.data_ptr(), h, w, DCT_MATRIX.ctypes.data, *rest)
        build.check(err, "dmmt_plane_dct_mm")
        build.LAUNCHES["plane_dct_mm"] += 1
    return out
