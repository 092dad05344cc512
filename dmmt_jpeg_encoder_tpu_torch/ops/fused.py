"""Block DCT kernel wrapper (DCTVariant.FUSED): DCT, zigzag and quantize as
one [N, 64] @ M[64, 64] product per block, then round.

Counterpart of dmmt_jpeg_encoder_tpu.ops.fused.fused_dct_quantize_zigzag.
`fused_matrix` builds M exactly as the JAX package does: the float64
Kronecker matrix of the 2-D DCT, columns permuted into zigzag order, cast
to float32, then a float32 divide by the zigzag-ordered table. The JAX
reference's product is XLA's CPU dot, which sums each output as ONE
sequential fma chain over i = 0..63 (the first term a plain product); the
plain version (`fused_reference`) and the CUDA kernel (csrc/block_dct.cu)
compute that chain.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import build
from ..tables import ZIGZAG
from ..utils.device import device_constant
from .dct import dct_matrix
from .fma import fma
from .quantize import round_half_away_from_zero


def _kron_dct64() -> np.ndarray:
    """K[i, r] (float64): contribution of flat input sample i = y * 8 + x
    to flat DCT coefficient r = v * 8 + u."""
    c = dct_matrix().astype(np.float64)
    return np.einsum("vy,ux->yxvu", c, c).reshape(64, 64)


def fused_matrix(qtable: np.ndarray) -> np.ndarray:
    """M [64, 64] float32: DCT x zigzag x (1 / q) folded into one matrix."""
    k = _kron_dct64()[:, ZIGZAG].astype(np.float32)
    q = np.asarray(qtable).astype(np.float32)[ZIGZAG]
    return k / q[None, :]


def fused_reference(blocks: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Plain version: float32 [N, 8, 8] blocks + M -> int16 [N, 64]."""
    x = blocks.reshape(-1, 64)
    acc = x[:, :1] * m[0]
    for i in range(1, 64):
        acc = fma(x[:, i : i + 1], m[i], acc)
    return round_half_away_from_zero(acc).to(torch.int16)


def fused_dct_quantize_zigzag(blocks: torch.Tensor, qtable: np.ndarray) -> torch.Tensor:
    """float32 [N, 8, 8] blocks + raster [64] table (host) -> int16 [N, 64]
    quantized coefficients in zigzag order."""
    m = device_constant(fused_matrix(qtable), blocks.device)
    if blocks.device.type == "cpu":
        return fused_reference(blocks, m)
    if blocks.device.type != "cuda":
        raise ValueError(f"block_dct_zz kernel needs a CUDA tensor, got {blocks.device}")
    if blocks.dtype != torch.float32 or blocks.shape[1:] != (8, 8):
        raise ValueError(f"expected float32 [N, 8, 8] blocks, got {blocks.dtype} {tuple(blocks.shape)}")
    blocks = blocks.contiguous()
    out = torch.empty((int(blocks.shape[0]), 64), dtype=torch.int16, device=blocks.device)
    err = build.load().dmmt_block_dct_zz(
        blocks.data_ptr(), int(blocks.shape[0]), m.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(blocks.device).cuda_stream,
    )
    build.check(err, "dmmt_block_dct_zz")
    build.LAUNCHES["block_dct_zz"] += 1
    return out
