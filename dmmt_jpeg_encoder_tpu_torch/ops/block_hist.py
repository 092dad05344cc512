"""Histogram kernel wrapper: DC-category and AC-symbol counts in one pass.

Counterpart of dmmt_jpeg_encoder_tpu.ops.pallas_block_hist
(`fused_block_histograms`, the JAX default DMMT_HIST=fused). The CUDA
kernel is csrc/block_hist.cu; its plain version is
`block_histograms_plain`. The chroma call passes Cb and Cr as a pair of
segments, counted in one launch as their concatenation without making
it. A call needs no zero fill: the kernel's first CTA zeroes the output
while the others count, and says so through a small state buffer that
the wrapper keeps per stream (zeroed once, at the stream's first call).
A captured CUDA graph bakes the state's pointer in, so a captured
program owns its state: it allocates one with `new_state` before the
capture and passes it as `state`, and no other graph or stream shares it.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from ..entropy.categorize import ac_symbols_and_structure, magnitude_category
from ..kernels import build

# int32 words of the kernel's state (csrc/block_hist.cu): a 64-bit ticket
# count and epoch, then the flag of the epoch whose output is zeroed
STATE_INTS = 4
# (device index, stream handle) -> the kernel's state on that stream
_STATES: dict[tuple[int, int], torch.Tensor] = {}


def block_histograms_plain(coeffs_zz: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain version: (dc_hist[16], ac_hist[256]) int32 for
    [N, 64] zigzag blocks whose DC entries are already DPCM deltas
    (symbol_counting.rs:55-74)."""
    dc_hist = torch.bincount(magnitude_category(coeffs_zz[:, 0]), minlength=16)
    symbols, nz, zrl, eob = ac_symbols_and_structure(coeffs_zz)
    ac_hist = torch.bincount(symbols[nz], minlength=256)
    ac_hist[0xF0] += zrl.sum()
    ac_hist[0x00] += eob.sum()
    return dc_hist.to(torch.int32), ac_hist.to(torch.int32)


def new_state(device: torch.device) -> torch.Tensor:
    """A zeroed kernel state of one stream or one captured program."""
    return torch.zeros(STATE_INTS, dtype=torch.int32, device=device)


def kernel_state(device: torch.device, state: torch.Tensor | None) -> tuple[torch.Tensor, int]:
    """(the state a launch uses, the current stream's handle): `state` when
    given (a captured program's own), else the current stream's."""
    stream = torch.cuda.current_stream(device).cuda_stream
    if state is None:
        key = (device.index, stream)
        if key not in _STATES:
            _STATES[key] = new_state(device)
        state = _STATES[key]
    elif state.device != device or state.dtype != torch.int32 or state.numel() != STATE_INTS:
        raise ValueError(f"expected an int32 [{STATE_INTS}] state on {device}")
    return state, stream


def fused_block_histograms(
    coeffs_zz: torch.Tensor | tuple[torch.Tensor, torch.Tensor], n_valid: int | None = None,
    state: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dc_hist int32 [16], ac_hist int32 [256]) over the first `n_valid`
    (default: all) int16 [N, 64] zigzag blocks, DC already DPCM'd. A pair
    of such tensors (Cb, Cr) counts as their concatenation. `state`: the
    kernel state to use (kernel_state), default the current stream's."""
    segments = (coeffs_zz,) if isinstance(coeffs_zz, torch.Tensor) else tuple(coeffs_zz)
    if not 1 <= len(segments) <= 2:
        raise ValueError(f"expected one or two segments of blocks, got {len(segments)}")
    sizes = [int(s.shape[0]) for s in segments]
    n = sum(sizes)
    n_valid = n if n_valid is None else int(n_valid)
    if not 0 <= n_valid <= n:
        raise ValueError(f"n_valid {n_valid} outside 0..{n}")
    dev = segments[0].device
    if any(s.device != dev for s in segments):
        raise ValueError(f"segments on different devices: {[str(s.device) for s in segments]}")
    if dev.type == "cpu":
        whole = segments[0] if len(segments) == 1 else torch.cat(segments)
        return block_histograms_plain(whole[:n_valid])
    if dev.type != "cuda":
        raise ValueError(f"histogram kernel needs a CUDA tensor, got {dev}")
    for s in segments:
        if s.dtype != torch.int16 or s.ndim != 2 or s.shape[1] != 64:
            raise ValueError(f"expected int16 [N, 64] blocks, got {s.dtype} {tuple(s.shape)}")
    a, *rest = (s.contiguous() for s in segments)
    b = rest[0] if rest else None
    n_a = min(n_valid, sizes[0])
    state, stream = kernel_state(dev, state)
    out = torch.empty(16 + 256, dtype=torch.int32, device=dev)
    err = build.load().dmmt_block_hist(
        a.data_ptr(), n_a, None if b is None else b.data_ptr(), n_valid - n_a,
        state.data_ptr(), out.data_ptr(), stream,
    )
    build.check(err, "dmmt_block_hist")
    build.LAUNCHES["block_hist"] += 1
    return out[:16], out[16:]
