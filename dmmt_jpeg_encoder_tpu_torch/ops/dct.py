"""Arai-Agui-Nakajima 8-point DCT (torch), the ARAI variant of the JAX
package (dmmt_jpeg_encoder_tpu.ops.dct).

`arai_butterfly` keeps the f32 operation order of the reference dataflow
(reference: src/cosine_transform/arai.rs:29-95) op for op, with the
roundings of the JAX reference as XLA's CPU backend compiles it (see
ops/fma.py): XLA computes each of the eight outputs separately, so every
product by an Arai constant has a single use and fuses into the add or
subtract that consumes it. In v44 and v46 both operands are products;
LLVM fuses the first, so m = (v24 + v26) * A5 is rounded on its own:

    v44 = fma(-v24, A2, -m)     v46 = fma(v26, A4, -m)    m = (v24 + v26) * A5
    v52 = fma(v32, A1, v23)     v53 = fma(-v32, A1, v23)
    v55 = fma(v25, A3, v17)     v57 = fma(-v25, A3, v17)

The constants are float32 values; the phase-1 CUDA kernel receives these
same values (ops/fused_arai.py) and fuses at the same points.

The SIMPLE and SEPARATED variants, and the matmul DCT of DMMT_P1=mxu and
fused1, are contractions with the DCT-II matrix C (`dct_matrix`). XLA's
CPU backend computes each 8-term contraction of the JAX reference in one
order, reproduced by `contract8`: term n goes to accumulator n mod 4
through an fma (the first term of each accumulator is a plain product),
and the accumulators combine as (a0 + a1) + (a2 + a3). A 2-D transform
runs the column pass (over y) first, then the row pass (over x). So the
three give the same floats; the CUDA kernels use the same order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .fma import fma

# --- Arai constants (src/cosine_transform/arai.rs:7-26) -----------------------

A1 = np.float32(1.0 / math.sqrt(2.0))
A2 = np.float32(0.5411961)
A3 = A1
A4 = np.float32(1.3065629)
A5 = np.float32(0.3826834)

S = tuple(
    np.float32(s)
    for s in (
        0.3535533,
        0.2548978,
        0.27059805,
        0.30067244,
        0.35355338,
        0.4499881,
        0.6532815,
        1.2814577,
    )
)


def arai_butterfly(v):
    """The raw 8-point AAN dataflow on EIGHT same-shaped float32 tensors;
    returns the 8 outputs (bit-exact op order of arai.rs:29-95)."""
    v00, v01, v02, v03, v04, v05, v06, v07 = v

    def c(x):
        return torch.tensor(float(x), dtype=torch.float32, device=v00.device)

    a1, a2, a3, a4, a5 = (c(a) for a in (A1, A2, A3, A4, A5))

    v10 = v00 + v07
    v11 = v01 + v06
    v12 = v02 + v05
    v13 = v03 + v04
    v14 = v03 - v04
    v15 = v02 - v05
    v16 = v01 - v06
    v17 = v00 - v07

    v20 = v10 + v13
    v21 = v11 + v12
    v22 = v11 - v12
    v23 = v10 - v13
    v24 = -v14 - v15
    v25 = v15 + v16
    v26 = v16 + v17

    v30 = v20 + v21
    v31 = v20 - v21
    v32 = v22 + v23

    m = (v24 + v26) * a5
    v44 = fma(-v24, a2, -m)
    v46 = fma(v26, a4, -m)

    v52 = fma(v32, a1, v23)
    v53 = fma(-v32, a1, v23)
    v55 = fma(v25, a3, v17)
    v57 = fma(-v25, a3, v17)

    v64 = v44 + v57
    v65 = v55 + v46
    v66 = v55 - v46
    v67 = v57 - v44

    outs = (v30, v65, v52, v67, v31, v64, v53, v66)
    return tuple(o * c(s) for o, s in zip(outs, S))


def arai_pass(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """One 8-point AAN pass along `dim` (size 8), vectorized over all other
    dims."""
    y = arai_butterfly(tuple(x.unbind(dim)))
    return torch.stack(y, dim=dim)


def dct_matrix() -> np.ndarray:
    """8-point DCT-II matrix C (float32): row k is s_k cos((2n+1) k pi / 16)
    with s_0 = 1/(2 sqrt 2), s_k = 1/2, computed in float64, then cast."""
    c = np.zeros((8, 8), dtype=np.float64)
    for k in range(8):
        s = math.sqrt(1.0 / 8.0) if k == 0 else 0.5
        for n in range(8):
            c[k, n] = s * math.cos((2 * n + 1) * k * math.pi / 16.0)
    return c.astype(np.float32)


def contract8(xs, ws) -> torch.Tensor:
    """sum_n xs[n] * ws[n] over eight same-shaped float32 tensors and eight
    float32 weights, in the order of the module docstring."""
    acc = [xs[k] * ws[k] for k in range(4)]
    acc = [fma(xs[k + 4], ws[k + 4], acc[k]) for k in range(4)]
    return (acc[0] + acc[1]) + (acc[2] + acc[3])


def matmul_dct_pass(x: torch.Tensor, dim: int) -> torch.Tensor:
    """out[k] = sum_n C[k, n] x[n] along `dim` (size 8), by contract8."""
    c = torch.from_numpy(dct_matrix()).to(x.device)
    xs = x.unbind(dim)
    return torch.stack([contract8(xs, c[k]) for k in range(8)], dim=dim)


def dct2d(blocks: torch.Tensor) -> torch.Tensor:
    """The SIMPLE and SEPARATED 2-D DCT of float32 [N, 8, 8] blocks (y, x):
    C X C^T, columns, then rows. The encode runs it on the plane through
    the matmul plane DCT kernel (ops/mxu_dct), whose floats equal these."""
    return matmul_dct_pass(matmul_dct_pass(blocks, 1), 2)


def idct2d(coeffs: torch.Tensor) -> torch.Tensor:
    """Inverse 2-D DCT of float32 [N, 8, 8] coefficients, C^T X C (tests
    only; the reference's InverseSimple, src/cosine_transform/simple.rs:101-141)."""
    c = torch.from_numpy(dct_matrix()).to(coeffs.device)
    return c.T @ coeffs @ c
