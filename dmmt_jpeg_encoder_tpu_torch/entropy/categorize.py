"""Entropy-stage analysis in torch (dmmt_jpeg_encoder_tpu.entropy.categorize).

- Magnitude category (categorize.rs:21-43): bit length of |v|, read from
  the float32 exponent (exact below 2^24).
- AC run lengths (categorize.rs:132-151): for each nonzero at zigzag
  position p, run = p - prev_nonzero(p) - 1, where prev_nonzero is an
  exclusive running max over p*[v != 0]. Runs > 15 emit floor(run/16) ZRL
  symbols; trailing zeros emit one EOB.
- Histograms (symbol_counting.rs:55-74): `symbol_histograms` routes on
  DMMT_HIST as the JAX package does: "fused" (the default) runs the
  one-pass block-histogram kernel (ops/block_hist.py); "pallas" and
  "matmul" count the symbols from the structure below with the weighted
  histogram kernel (ops/histogram.py). `batched_symbol_histograms` counts
  per image with that kernel's grouped form (the fused batch).
"""

from __future__ import annotations

import os

import torch


def magnitude_category(v: torch.Tensor) -> torch.Tensor:
    """JPEG magnitude category (int32) = bit length of |v|, 0 for v == 0."""
    a = torch.abs(v.to(torch.int32))
    bits = a.to(torch.float32).view(torch.int32)
    return torch.where(a > 0, (bits >> 23) - 126, torch.zeros_like(a))


def running_max(x: torch.Tensor) -> torch.Tensor:
    """Inclusive running max along dim 1 of an [N, K] tensor (contiguous).
    Scanned on the transposed copy: on the H100, PyTorch's scans along a
    short innermost axis ran at ~10 GB/s, along the outer axis at memory
    speed (PERF.md, PR 3)."""
    return torch.cummax(x.t().contiguous(), dim=0).values.t().contiguous()


def running_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive running sum along dim 1 of an [N, K] tensor, in its dtype;
    scanned on the transposed copy as running_max is."""
    return torch.cumsum(x.t().contiguous(), dim=0, dtype=x.dtype).t().contiguous()


def ac_symbols_and_structure(
    coeffs_zz: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """AC run/size structure for [N, 64] zigzag blocks.

    Returns (symbols, nonzero_mask, zrl_counts, eob_mask):
      symbols  int32 [N, 63]: (run % 16) << 4 | category, valid where nonzero
      nonzero  bool  [N, 63]
      zrl      int32 [N, 63]: floor(run/16) ZRL emissions before each nonzero
      eob      bool  [N]: block emits an EOB (trailing zeros exist)
    """
    ac = coeffs_zz[:, 1:].to(torch.int32)
    pos = torch.arange(1, 64, dtype=torch.int32, device=ac.device)[None, :]
    nz = ac != 0
    nzpos = torch.where(nz, pos, torch.zeros_like(ac))
    shifted = torch.cat([torch.zeros_like(ac[:, :1]), nzpos[:, :-1]], dim=1)
    prev_nz = running_max(shifted)
    run = pos - prev_nz - 1
    zrl = torch.where(nz, run >> 4, torch.zeros_like(run))
    symbols = ((run & 15) << 4) | magnitude_category(ac)
    eob = nzpos.amax(dim=1) < 63
    return symbols, nz, zrl, eob


def symbol_histograms(
    coeffs_zz: torch.Tensor | tuple[torch.Tensor, torch.Tensor],
    block_mask: torch.Tensor | None = None,
    state: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dc_hist[16], ac_hist[256]) int32 for [N, 64] zigzag blocks whose DC
    entries are already DPCM deltas, or for a pair of them (Cb, Cr) as
    their concatenation, counting only the blocks where `block_mask` ([N],
    optional) is nonzero. The block-histogram kernel takes a pair as two
    segments; the weighted kernel counts the concatenation. A masked count
    always takes the weighted kernel, as in the JAX package (the sharded
    encode's mask over Cb and Cr together is no prefix). `state`: the
    kernels' state (ops/block_hist.kernel_state), default the stream's."""
    from ..ops.block_hist import fused_block_histograms
    from ..ops.histogram import histogram

    if os.environ.get("DMMT_HIST", "fused") == "fused" and block_mask is None:
        return fused_block_histograms(coeffs_zz, state=state)
    if not isinstance(coeffs_zz, torch.Tensor):
        coeffs_zz = torch.cat(list(coeffs_zz))
    n = int(coeffs_zz.shape[0])
    weight = (torch.ones(n, dtype=torch.int32, device=coeffs_zz.device) if block_mask is None
              else (block_mask != 0).to(torch.int32))
    dc_cat = magnitude_category(coeffs_zz[:, 0])
    dc_hist = histogram(dc_cat, weight, 16, state)
    symbols, nz, zrl, eob = ac_symbols_and_structure(coeffs_zz)
    ac_hist = histogram(symbols, nz.to(torch.int32) * weight[:, None], 256, state)
    ac_hist[0xF0] += (zrl * weight[:, None]).sum(dtype=torch.int32)
    ac_hist[0x00] += (eob.to(torch.int32) * weight).sum(dtype=torch.int32)
    return dc_hist, ac_hist


def batched_symbol_histograms(
    coeffs_zz: torch.Tensor, state: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-image histograms for [B, N, 64] blocks -> int32 ([B, 16],
    [B, 256]), each as symbol_histograms gives it for one image. `state`:
    the weighted-histogram kernel's state, as for symbol_histograms."""
    from ..ops.histogram import histogram_grouped

    b, n, _ = coeffs_zz.shape
    flat = coeffs_zz.reshape(b * n, 64)
    dc_cat = magnitude_category(flat[:, 0]).reshape(b, n)
    dc_hist = histogram_grouped(dc_cat, torch.ones_like(dc_cat), 16, state)
    symbols, nz, zrl, eob = ac_symbols_and_structure(flat)
    ac_hist = histogram_grouped(symbols.reshape(b, -1), nz.reshape(b, -1).to(torch.int32), 256,
                                state)
    ac_hist[:, 0xF0] += zrl.reshape(b, -1).sum(dim=1, dtype=torch.int32)
    ac_hist[:, 0x00] += eob.reshape(b, n).sum(dim=1, dtype=torch.int32)
    return dc_hist, ac_hist
