"""RGB -> YCbCr color conversion (torch).

Same numerical contract as dmmt_jpeg_encoder_tpu.ops.color, including the
fold of the JPEG -128 level shift into the luma weights and signed chroma
(reference: src/color.rs:75-100):

    luma = (0.299 r + 0.587 g + 0.114 b - 128/255) * 255   in [-128, 127]
    cb   = (-0.1687 r - 0.3312 g + 0.5 b) * 255
    cr   = (0.5 r - 0.4186 g - 0.0813 b) * 255

with the roundings of the JAX reference as XLA's CPU backend compiles it
(see ops/fma.py): each weighted sum is fma(b, w2, fma(r, w0, g * w1)).
The chroma scale by 255 is left to the caller (`chroma_sums`), because
the reference fuses it into the subsample adds (ops/geometry.py). Every
constant is a float32 value, so no op computes in double; the phase-1
CUDA kernel receives these same values (ops/fused_arai.kernel_constants).
"""

from __future__ import annotations

import numpy as np
import torch

from .fma import fma

LEVEL_SHIFT = np.float32(128.0 / 255.0)
Y_WEIGHTS = tuple(np.float32(c) for c in (0.299, 0.587, 0.114))
CB_WEIGHTS = tuple(np.float32(c) for c in (-0.1687, -0.3312, 0.5))
CR_WEIGHTS = tuple(np.float32(c) for c in (0.5, -0.4186, -0.0813))
SCALE = np.float32(255.0)


def f32(x: float) -> torch.Tensor:
    """A float32 scalar: a 0-dim CPU tensor, which torch applies to a
    tensor on any device as a scalar, so no op waits for an upload. Not a
    divisor (but a power of two): torch on a card multiplies by the
    float32 reciprocal of a CPU scalar divisor."""
    return torch.tensor(float(x), dtype=torch.float32)


def _weighted_sum(r, g, b, weights) -> torch.Tensor:
    w0, w1, w2 = (f32(w) for w in weights)
    return fma(b, w2, fma(r, w0, g * w1))


def luma(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 planes in 0..1 -> level-shifted luma plane."""
    return (_weighted_sum(r, g, b, Y_WEIGHTS) - f32(LEVEL_SHIFT)) * f32(SCALE)


def chroma_sums(
    r: torch.Tensor, g: torch.Tensor, b: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 planes in 0..1 -> (cb, cr) BEFORE the scale by 255."""
    return _weighted_sum(r, g, b, CB_WEIGHTS), _weighted_sum(r, g, b, CR_WEIGHTS)
