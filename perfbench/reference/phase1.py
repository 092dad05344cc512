"""Plain phase 1 of the reference encoder: integer RGB -> DPCM'd zigzag blocks.

A frozen copy of the PyTorch port's plain path at commit 403a63c
(dmmt_jpeg_encoder_tpu_torch: ops/fma.py, ops/color.py, ops/geometry.py
`subsample_scaled` and `entangle_quads`, ops/dct.py `arai_butterfly`,
ops/quantize.py, pipeline.py `ycbcr_planes`, `plane_dct_quant`,
`plane_to_zigzag_blocks`, `dc_dpcm`), cut to the ARAI variant and
written as one chain of plain torch operations:

    / maxval -> pad black to the MCU multiple -> RGB->YCbCr -> subsample
    -> Arai rows, then columns -> / q -> round half away from zero ->
    int16 -> zigzag -> P420 quad entangle -> DC DPCM

The encoder's bytes are those of the JAX package on XLA's CPU backend,
which fuses a single-use product into the add that follows it. So the
chain rounds once at those points (`fma`) and after every other operation,
as the port's plain path does; a strict per-operation float32 chain
differs at rare .5 boundaries.

`precision="bfloat16"` is the benchmark's control: the same chain with
every intermediate plane rounded to bfloat16, the next precision below
float32. It is never the reference.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

LEVEL_SHIFT = np.float32(128.0 / 255.0)
Y_WEIGHTS = tuple(np.float32(c) for c in (0.299, 0.587, 0.114))
CB_WEIGHTS = tuple(np.float32(c) for c in (-0.1687, -0.3312, 0.5))
CR_WEIGHTS = tuple(np.float32(c) for c in (0.5, -0.4186, -0.0813))
SCALE = np.float32(255.0)

A1 = np.float32(1.0 / math.sqrt(2.0))
A2 = np.float32(0.5411961)
A3 = A1
A4 = np.float32(1.3065629)
A5 = np.float32(0.3826834)
S = tuple(np.float32(s) for s in (0.3535533, 0.2548978, 0.27059805, 0.30067244,
                                   0.35355338, 0.4499881, 0.6532815, 1.2814577))

# ZIGZAG[k] = raster index of the k-th zigzag coefficient
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], dtype=np.int64)

# (horizontal, vertical) sampling rates of each preset
RATES = {"P444": (1, 1), "P422": (2, 1), "P420": (2, 2)}


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 round(a * b + c) with a single rounding: a * b is exact in
    float64, TwoSum gives the float64 sum's error, and rounding to odd
    before the cast to float32 rounds the exact value correctly."""
    a64, b64, c64 = (torch.as_tensor(x).to(torch.float64) for x in (a, b, c))
    p = a64 * b64
    s = p + c64
    bp = s - c64
    err = (p - bp) + (c64 - (s - bp))
    bits = s.view(torch.int64)
    inexact = err != 0
    above = inexact & ((err < 0) != (s < 0))
    bits = torch.where(above, bits - 1, bits)
    bits = torch.where(inexact, bits | 1, bits)
    return bits.view(torch.float64).to(torch.float32)


def f32(x: float) -> torch.Tensor:
    """A float32 scalar as a 0-dim CPU tensor (never a divisor other than a
    power of two: torch on a card multiplies by a CPU scalar divisor's
    reciprocal)."""
    return torch.tensor(float(x), dtype=torch.float32)


def padded_size(height: int, width: int, preset: str) -> tuple[int, int]:
    hr, vr = RATES[preset]
    mh, mw = 8 * vr, 8 * hr
    return -(-height // mh) * mh, -(-width // mw) * mw


def _weighted_sum(r, g, b, weights) -> torch.Tensor:
    w0, w1, w2 = (f32(w) for w in weights)
    return fma(b, w2, fma(r, w0, g * w1))


def _subsample_scaled(chroma_sum: torch.Tensor, preset: str) -> torch.Tensor:
    s = f32(SCALE)
    if preset == "P444":
        return chroma_sum * s
    if preset == "P422":
        return fma(chroma_sum[:, 0::2], s, chroma_sum[:, 1::2] * s) / f32(2.0)
    tl, tr = chroma_sum[0::2, 0::2], chroma_sum[0::2, 1::2]
    bl, br = chroma_sum[1::2, 0::2], chroma_sum[1::2, 1::2]
    return fma(br, s, fma(tr, s, fma(tl, s, bl * s))) / f32(4.0)


def _arai_pass(x: torch.Tensor, dim: int, rnd) -> torch.Tensor:
    """One 8-point Arai-Agui-Nakajima pass along `dim` (size 8), in the
    reference dataflow's operation order."""
    v00, v01, v02, v03, v04, v05, v06, v07 = x.unbind(dim)
    a1, a2, a3, a4, a5 = (f32(a) for a in (A1, A2, A3, A4, A5))
    v10, v11, v12, v13 = v00 + v07, v01 + v06, v02 + v05, v03 + v04
    v14, v15, v16, v17 = v03 - v04, v02 - v05, v01 - v06, v00 - v07
    v20, v21, v22, v23 = v10 + v13, v11 + v12, v11 - v12, v10 - v13
    v24, v25, v26 = -v14 - v15, v15 + v16, v16 + v17
    v30, v31, v32 = v20 + v21, v20 - v21, v22 + v23
    m = (v24 + v26) * a5
    v44 = fma(-v24, a2, -m)
    v46 = fma(v26, a4, -m)
    v52 = fma(v32, a1, v23)
    v53 = fma(-v32, a1, v23)
    v55 = fma(v25, a3, v17)
    v57 = fma(-v25, a3, v17)
    outs = (v30, v55 + v46, v52, v57 - v44, v31, v44 + v57, v53, v55 - v46)
    return rnd(torch.stack([o * f32(s) for o, s in zip(outs, S)], dim=dim))


def _dct_quant(plane: torch.Tensor, qtable: np.ndarray, rnd) -> torch.Tensor:
    """float32 [H, W] plane -> int16 quantized coefficient plane: Arai rows,
    then columns, / q, round half away from zero."""
    hh, ww = plane.shape
    a, b = hh // 8, ww // 8
    r = _arai_pass(plane.reshape(hh, b, 8), -1, rnd).reshape(a, 8, b, 8)
    c = _arai_pass(r, 1, rnd)
    qv = torch.from_numpy(np.asarray(qtable, dtype=np.float32)).to(plane.device).reshape(8, 8)
    scaled = rnd(c / qv[None, :, None, :])
    half = torch.tensor(0.5, dtype=torch.float32, device=plane.device)
    rounded = torch.sign(scaled) * torch.floor(torch.abs(scaled) + half)
    return rounded.to(torch.int16).reshape(hh, ww)


def _zigzag_blocks(coeffs: torch.Tensor, entangle: bool) -> torch.Tensor:
    """int16 coefficient plane -> [N, 64] zigzag blocks, in P420 MCU
    (quad: TL, TR, BL, BR) order when `entangle`, else raster order."""
    hh, ww = coeffs.shape
    a, b = hh // 8, ww // 8
    blk = coeffs.reshape(a, 8, b, 8).permute(0, 2, 1, 3).reshape(-1, 64)
    blk = blk[:, torch.from_numpy(ZIGZAG).to(blk.device)]
    if entangle:
        blk = blk.reshape(a // 2, 2, b // 2, 2, 64).permute(0, 2, 1, 3, 4).reshape(-1, 64)
    return blk.contiguous()


def _dc_dpcm(blocks: torch.Tensor) -> torch.Tensor:
    """Column 0 (DC) replaced by its delta chain from predictor 0."""
    dc = blocks[:, 0].to(torch.int32)
    prev = F.pad(dc[:-1], (1, 0))
    out = blocks.clone()
    out[:, 0] = (dc - prev).to(blocks.dtype)
    return out


def zigzag_blocks(rgb: torch.Tensor, maxval: int, luma_q: np.ndarray, chroma_q: np.ndarray,
                  preset: str, precision: str = "float32"):
    """Integer RGB [H, W, 3] on any device -> (luma, cb, cr) int16 [N, 64]
    zigzag blocks after DC DPCM: luma in MCU order, chroma in raster order."""
    if precision == "float32":
        def rnd(x):
            return x
    elif precision == "bfloat16":
        def rnd(x):
            return x.to(torch.bfloat16).to(torch.float32)
    else:
        raise ValueError(f"unknown precision {precision!r}")
    mv = torch.tensor(float(maxval), dtype=torch.float32, device=rgb.device)
    h, w = int(rgb.shape[0]), int(rgb.shape[1])
    ph, pw = padded_size(h, w, preset)
    norm = rnd(F.pad(rgb.to(torch.float32) / mv, (0, 0, 0, pw - w, 0, ph - h)))
    r, g, b = norm.unbind(-1)
    y = rnd((_weighted_sum(r, g, b, Y_WEIGHTS) - f32(LEVEL_SHIFT)) * f32(SCALE))
    cb, cr = (rnd(_subsample_scaled(rnd(_weighted_sum(r, g, b, wts)), preset))
              for wts in (CB_WEIGHTS, CR_WEIGHTS))
    luma = _zigzag_blocks(_dct_quant(y, luma_q, rnd), preset == "P420")
    return tuple(_dc_dpcm(x) for x in (luma, *(_zigzag_blocks(_dct_quant(c, chroma_q, rnd), False)
                                               for c in (cb, cr))))
