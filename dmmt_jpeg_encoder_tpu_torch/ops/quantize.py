"""Quantizer rounding (torch).

The reference quantizer divides by the table entry and rounds HALF AWAY
FROM ZERO (Rust f32::round; reference:
src/image/writer/jpeg/transformer/quantizer.rs:53-63), written exactly as
the JAX package writes it. `torch.round` rounds half to even and is never
used here.
"""

from __future__ import annotations

import torch

from ..tables import ZIGZAG


def round_half_away_from_zero(x: torch.Tensor) -> torch.Tensor:
    half = torch.tensor(0.5, dtype=x.dtype, device=x.device)
    return torch.sign(x) * torch.floor(torch.abs(x) + half)


def quantize_zigzag(coeffs: torch.Tensor, qtable: torch.Tensor) -> torch.Tensor:
    """float32 [N, 8, 8] DCT coefficients + raster [64] table -> int16
    [N, 64] quantized coefficients in zigzag order. The JAX package reorders
    with an exact one-hot matmul; a gather gives the same values."""
    flat = coeffs.reshape(-1, 64) / qtable.to(device=coeffs.device, dtype=torch.float32)
    zz = torch.as_tensor(ZIGZAG, dtype=torch.long, device=coeffs.device)
    return round_half_away_from_zero(flat[:, zz]).to(torch.int16)
