"""Weighted histogram kernel wrapper (DMMT_HIST=pallas/matmul, fused batch).

Counterpart of dmmt_jpeg_encoder_tpu.ops.pallas_histogram
(`pallas_histogram`, `pallas_histogram_grouped`). The CUDA kernel is
csrc/histogram.cu; `histogram` is its one-group form. The JAX package's
`matmul_histogram` (an MXU contraction of nibble one-hots) gives the same
counts, so DMMT_HIST=matmul runs this kernel too.

Weights are integers (the JAX fallback casts them to int32; every caller
passes 0/1), counts are exact int32, and a symbol outside [0, n_bins)
counts nowhere, as the TPU kernel's per-bin compare drops it. A call needs
no zero fill: the kernel's first CTA zeroes the output while the others
count, and says so through the small per-stream state of the
block-histogram kernel (ops/block_hist.py), whose protocol it shares: each
call leaves the state ready for the next on its stream, whichever of the
two kernels that is. A captured program passes its own state, as there.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from ..kernels import build
from .block_hist import kernel_state


def histogram_grouped_plain(symbols: torch.Tensor, weights: torch.Tensor, n_bins: int) -> torch.Tensor:
    """The kernel's plain version: [G, M] symbols and weights -> int32
    [G, n_bins] weighted counts per group."""
    g = int(symbols.shape[0])
    s = symbols.to(torch.int64)
    keep = (s >= 0) & (s < n_bins)
    idx = (s + torch.arange(g, device=s.device)[:, None] * n_bins)[keep]
    out = torch.zeros(g * n_bins, dtype=torch.int64, device=s.device)
    out.index_add_(0, idx, weights.to(torch.int64)[keep])
    return out.reshape(g, n_bins).to(torch.int32)


def histogram_grouped(symbols: torch.Tensor, weights: torch.Tensor, n_bins: int,
                      state: torch.Tensor | None = None) -> torch.Tensor:
    """Per-group weighted histograms: int [G, M] symbols and integer [G, M]
    weights -> int32 [G, n_bins]. `state`: the kernel state to use
    (block_hist.kernel_state), default the current stream's."""
    if symbols.ndim != 2 or weights.shape != symbols.shape:
        raise ValueError(f"expected [G, M] symbols and weights, got {tuple(symbols.shape)} "
                         f"and {tuple(weights.shape)}")
    if not 1 <= n_bins <= 256:
        raise ValueError(f"n_bins {n_bins} outside 1..256")
    if symbols.device.type == "cpu":
        return histogram_grouped_plain(symbols, weights, n_bins)
    if symbols.device.type != "cuda":
        raise ValueError(f"histogram kernel needs a CUDA tensor, got {symbols.device}")
    g, m = (int(x) for x in symbols.shape)
    sym = symbols.to(torch.int32).contiguous()
    w = weights.to(device=sym.device, dtype=torch.int32).contiguous()
    state, stream = kernel_state(sym.device, state)
    out = torch.empty((g, n_bins), dtype=torch.int32, device=sym.device)
    err = build.load().dmmt_histogram_grouped(
        sym.data_ptr(), w.data_ptr(), g, m, n_bins, state.data_ptr(), out.data_ptr(), stream,
    )
    build.check(err, "dmmt_histogram_grouped")
    build.LAUNCHES["histogram"] += 1
    return out


def histogram(symbols: torch.Tensor, weights: torch.Tensor, n_bins: int,
              state: torch.Tensor | None = None) -> torch.Tensor:
    """Weighted histogram of int symbols of any shape (weights of the same
    shape) -> int32 [n_bins]."""
    return histogram_grouped(symbols.reshape(1, -1), weights.reshape(1, -1), n_bins, state)[0]
