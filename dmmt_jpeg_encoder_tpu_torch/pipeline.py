"""Phase 1 and the first dispatch of the two-dispatch encode.

The counterpart of dmmt_jpeg_encoder_tpu.pipeline in its default `plane`
mode (pipeline.py:159-232, 330-393 there):

    normalize (true f32 division by maxval) -> pad -> RGB->YCbCr ->
    subsample -> Arai DCT on plane layout -> / q -> round half away ->
    int16 -> zigzag -> P420 quad entangle -> DC DPCM

with the float32 roundings of the JAX reference as XLA's CPU backend
compiles it (ops/fma.py). `phase1_zigzag_blocks` is the phase-1 kernel's
plain version (ops/fused_arai.py); it runs on whatever device its tensors
lie on.

`run_device_pipeline` / `run_device_pipeline_batch` are the two-dispatch
encode's device phase: the phase-1 kernel, DC DPCM and the four symbol
histograms, left on the device (huffman/tables.HuffmanTables.from_histograms
fetches the histograms in one copy). The batch form runs phase 1 once over
the images row-stacked, each pre-padded to its MCU multiple, as the slab
does (onedispatch.pack_inputs), and counts per image with the grouped
histogram kernel. As in the JAX package, each is one program on a card:
one replay of a CUDA graph of its eager enqueue (`device_phase`,
`device_phase_batch`) from `_compiled_pipeline` / `_compiled_pipeline_batch`
(maxsize 32 / 16, keyed as the JAX package's plus programs.program_key),
whose instance the result holds until it is collected (its blocks are the
graph's outputs until then). The CPU runs the same enqueue eagerly
(programs.card decides).

`zigzag_blocks` turns RGB into DPCM'd zigzag blocks on every path (the
counterpart of the JAX package's encode_blocks_from_planes and
fused_phase1_zigzag_blocks). It routes as the JAX package does: the ARAI
variant on DMMT_P1: "pallas" runs the plane DCT kernel
(ops/pallas_dct, same bits as "plane"), "mxu" the matmul plane DCT kernel
(ops/mxu_dct) and "fused1" the fused matmul phase-1 kernel
(ops/fused_phase1), both not Arai-bit-exact, and both at the matmul
precision DMMT_P1_PREC selects (ops/mxu_dct: "high" passes `split` to
their kernels); every other value ("plane",
the default, and the layout modes plane_mm, plane2, block and fused2,
whose bits equal plane's) runs the phase-1 kernel (ops/fused_arai). A
DCT variant other than ARAI ignores DMMT_P1: FUSED runs the block DCT
kernel (ops/fused) on blockized planes, SIMPLE and SEPARATED the matmul
plane DCT kernel, whose floats equal theirs (C X C^T, the same summation
order; blockize only changes the layout) and do not read
DMMT_P1_PREC.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from functools import partial
from typing import Callable

import numpy as np
import torch

from . import programs
from .config import ChromaSubsamplingPreset, DCTVariant, EncoderConfig
from .entropy.categorize import batched_symbol_histograms, symbol_histograms
from .ops.color import chroma_sums, luma
from .ops.dct import arai_pass
from .ops.geometry import (
    blockize,
    entangle_quads,
    entangled_blockize_p420,
    pad_to_mcu_multiple,
    padded_size,
    subsample_scaled,
)
from .ops.quantize import round_half_away_from_zero
from .tables import ZIGZAG
from .utils.capability import mode_keyed_cache
from .utils.device import as_device, device_constant, narrow_pixels


def plane_to_zigzag_blocks(rounded16: torch.Tensor, entangle: bool) -> torch.Tensor:
    """int16 coefficient PLANE (v = row % 8, u = col % 8) -> int16 [N, 64]
    zigzag blocks, in P420 MCU (quad) order when `entangle`."""
    hh, ww = rounded16.shape
    a, b = hh // 8, ww // 8
    blk = rounded16.reshape(a, 8, b, 8).permute(0, 2, 1, 3).reshape(-1, 64)
    out = blk[:, device_constant(ZIGZAG.astype(np.int64), blk.device)]
    return entangle_quads(out, a, b) if entangle else out.contiguous()


def plane_dct_quant(plane: torch.Tensor, qtable: torch.Tensor) -> torch.Tensor:
    """float32 [H, W] plane (H, W multiples of 8) + raster [64] table ->
    int16 [H, W] quantized coefficient plane: Arai rows (along x), then
    columns (along y), / q, round half away from zero."""
    hh, ww = plane.shape
    a, b = hh // 8, ww // 8
    r = arai_pass(plane.reshape(hh, b, 8), dim=-1).reshape(a, 8, b, 8)
    c = arai_pass(r, dim=1)                                  # [A, 8v, B, 8u]
    qv = qtable.to(device=plane.device, dtype=torch.float32).reshape(8, 8)
    scaled = c / qv[None, :, None, :]
    return round_half_away_from_zero(scaled).to(torch.int16).reshape(hh, ww)


def ycbcr_planes(
    rgb: torch.Tensor, maxval: float, preset: ChromaSubsamplingPreset
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Integer RGB [H, W, 3] (unpadded) -> float32 (luma, subsampled Cb,
    subsampled Cr) planes of the image padded black to its MCU multiple:
    the plane path before its DCT. The divisor is a tensor on rgb's
    device: a CPU scalar divisor would make torch on a card multiply by
    its float32 reciprocal instead of dividing."""
    mv = device_constant(np.array(maxval, dtype=np.float32), rgb.device)
    norm = pad_to_mcu_multiple(rgb.to(torch.float32) / mv, preset)
    r, g, b = norm.unbind(-1)
    return luma(r, g, b), *(subsample_scaled(c, preset) for c in chroma_sums(r, g, b))


def phase1_zigzag_blocks(
    rgb: torch.Tensor,
    maxval: float,
    luma_q: torch.Tensor,
    chroma_q: torch.Tensor,
    preset: ChromaSubsamplingPreset,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Integer RGB [H, W, 3] (unpadded) -> (luma, cb, cr) int16 [N, 64]
    zigzag blocks BEFORE DC DPCM: luma in MCU order, chroma in raster
    order."""
    y, cb, cr = ycbcr_planes(rgb, maxval, preset)
    entangle = preset is ChromaSubsamplingPreset.P420
    return (plane_to_zigzag_blocks(plane_dct_quant(y, luma_q), entangle),
            *(plane_to_zigzag_blocks(plane_dct_quant(c, chroma_q), False) for c in (cb, cr)))


def zigzag_blocks(
    rgb: torch.Tensor,
    n_images: int,
    maxval: int,
    luma_q: np.ndarray,
    chroma_q: np.ndarray,
    preset: ChromaSubsamplingPreset,
    variant: DCTVariant,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Integer RGB [H, W, 3] (n_images row-stacked, each MCU-padded, when
    n_images > 1) + host raster tables -> (luma, cb, cr) int16 [N, 64]
    zigzag blocks with DC DPCM per image: luma in MCU order, chroma in
    raster order. Routes as the module docstring says."""
    mode = os.environ.get("DMMT_P1", "plane") if variant is DCTVariant.ARAI else None
    blocks = phase1_blocks(rgb, maxval, luma_q, chroma_q, preset, variant, mode)
    return tuple(dc_dpcm_per_image(x, n_images) for x in blocks)


def phase1_blocks(
    rgb: torch.Tensor,
    maxval: int,
    luma_q: np.ndarray,
    chroma_q: np.ndarray,
    preset: ChromaSubsamplingPreset,
    variant: DCTVariant,
    mode: str | None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """zigzag_blocks BEFORE the DC DPCM, with the DMMT_P1 value `mode`
    given (None for a variant other than ARAI): the sharded encode runs its
    own DPCM, chained across shards, and routes phase 1 otherwise
    (parallel/sharding.py)."""
    from .ops.fused import fused_dct_quantize_zigzag
    from .ops.fused_arai import fused_arai_phase1
    from .ops.fused_phase1 import fused_phase1
    from .ops.mxu_dct import check_p1_precision, plane_dct_quant_mxu
    from .ops.pallas_dct import plane_dct_quant as plane_dct_quant_kernel

    lq, cq = (device_constant(np.asarray(q), rgb.device) for q in (luma_q, chroma_q))
    entangle = preset is ChromaSubsamplingPreset.P420
    split = mode in ("mxu", "fused1") and check_p1_precision() == "high"
    if variant is DCTVariant.FUSED:
        y, cb, cr = ycbcr_planes(rgb, maxval, preset)
        blocks = (fused_dct_quantize_zigzag(entangled_blockize_p420(y) if entangle else blockize(y),
                                            luma_q),
                  *(fused_dct_quantize_zigzag(blockize(c), chroma_q) for c in (cb, cr)))
    elif mode == "fused1":
        y, cb, cr = fused_phase1(rgb, maxval, lq, cq, preset, split)
        blocks = (plane_to_zigzag_blocks(y, entangle),
                  *(plane_to_zigzag_blocks(c, False) for c in (cb, cr)))
    elif mode in ("pallas", "mxu", None):
        dct = plane_dct_quant_kernel if mode == "pallas" else partial(plane_dct_quant_mxu, split=split)
        y, cb, cr = ycbcr_planes(rgb, maxval, preset)
        # one chroma launch: Cb and Cr stacked (raster order: all Cb, then Cr)
        cbcr = plane_to_zigzag_blocks(dct(torch.cat([cb, cr]), cq), False)
        blocks = (plane_to_zigzag_blocks(dct(y, lq), entangle), *cbcr.chunk(2))
    else:
        blocks = fused_arai_phase1(rgb, maxval, lq, cq, preset)
    return blocks


def dc_dpcm(blocks: torch.Tensor) -> torch.Tensor:
    """Replace column 0 (DC) of [N, 64] blocks with its delta chain; the
    predictor starts at 0 (categorize.rs:156-161)."""
    return dc_dpcm_per_image(blocks, 1)


def dc_dpcm_per_image(
    blocks: torch.Tensor, n_images: int, first: torch.Tensor | None = None
) -> torch.Tensor:
    """dc_dpcm with chains that RESET at image boundaries: the block axis of
    a row-stacked slab is the concatenation of n_images equal-length
    per-image sequences, and each image's chain starts from predictor 0 as
    a standalone encode's does (pipeline.dc_dpcm_per_image of the JAX
    package), or from first[i] (int [n_images] on the blocks' device: a
    shard's chain continues the previous shard's). Computed in int32, then
    cast back."""
    dc = blocks[:, 0].to(torch.int32).reshape(n_images, -1)
    if first is None:
        prev = torch.nn.functional.pad(dc[:, :-1], (1, 0))
    else:
        prev = torch.cat([first.to(torch.int32).reshape(n_images, 1), dc[:, :-1]], dim=1)
    out = blocks.clone()
    out[:, 0] = (dc - prev).reshape(-1).to(blocks.dtype)
    return out


@dataclass
class DeviceEncodeResult:
    """The device phase of a two-dispatch encode: blocks and histograms on
    the device, until HuffmanTables.from_histograms replaces the histograms
    with their host copies."""

    luma: torch.Tensor | None   # int16 [NL, 64] zigzag, DC = DPCM delta, MCU order
    cb: torch.Tensor | None     # int16 [NC, 64]
    cr: torch.Tensor | None     # int16 [NC, 64]
    luma_dc_hist: torch.Tensor | np.ndarray    # int32 [16]
    luma_ac_hist: torch.Tensor | np.ndarray    # int32 [256]
    chroma_dc_hist: torch.Tensor | np.ndarray  # int32 [16]
    chroma_ac_hist: torch.Tensor | np.ndarray  # int32 [256]
    # gives a replay's program instance back when the result is collected
    # (a weakref.finalize): its blocks are the graph's outputs until then
    release: Callable | None = field(default=None, repr=False, compare=False)


def device_phase(
    rgb: torch.Tensor,
    maxval: int,
    config: EncoderConfig,
    luma_q: np.ndarray,
    chroma_q: np.ndarray,
    hist_state: torch.Tensor | None = None,
) -> DeviceEncodeResult:
    """Phase 1, DPCM and the four histograms of RGB [H, W, 3] on the
    device, enqueued op by op: what _compiled_pipeline captures (with its
    own histogram-kernel `hist_state`) and what the CPU runs."""
    luma, cb, cr = zigzag_blocks(rgb, 1, maxval, luma_q, chroma_q, config.chroma_subsampling,
                                 config.dct_variant)
    l_dc, l_ac = symbol_histograms(luma, state=hist_state)
    # the chroma tables are shared by Cb and Cr: one count over both
    c_dc, c_ac = symbol_histograms((cb, cr), state=hist_state)
    return DeviceEncodeResult(luma, cb, cr, l_dc, l_ac, c_dc, c_ac)


def run_device_pipeline(
    pixels: np.ndarray | torch.Tensor,
    maxval: int,
    config: EncoderConfig,
    luma_q: np.ndarray,
    chroma_q: np.ndarray,
    device: torch.device | str = "cuda",
) -> DeviceEncodeResult:
    """Enqueue phase 1, DPCM and the histograms of RGB [H, W, 3] samples: a
    host array is encoded on `device`, a tensor where it lies. On a card:
    one replay of the program (_compiled_pipeline), whose instance the
    result holds until it is collected; on the CPU: device_phase."""
    card = programs.card(pixels, device)
    if card is None:
        return device_phase(as_device(pixels, maxval, device), maxval, config, luma_q, chroma_q)
    pool = _compiled_pipeline(int(pixels.shape[0]), int(pixels.shape[1]),
                              config.chroma_subsampling, config.dct_variant,
                              *programs.program_key(pixels, maxval, luma_q, chroma_q, card))
    return programs.start(pool, pixels, maxval)[0]


@mode_keyed_cache(maxsize=32)
def _compiled_pipeline(height: int, width: int, preset: ChromaSubsamplingPreset,
                       variant: DCTVariant, device: torch.device, dtype: torch.dtype,
                       maxval: int, luma_key: tuple, chroma_key: tuple):
    """The first half of the two-dispatch encode of one [H, W, 3] image:
    device_phase. Keyed as the JAX package's program, plus
    programs.program_key."""
    config = EncoderConfig(chroma_subsampling=preset, dct_variant=variant)
    lq, cq = programs.key_table(luma_key), programs.key_table(chroma_key)

    def enqueue(x, state):
        return [device_phase(x, maxval, config, lq, cq, state)]

    return programs.pool("pipeline", (height, width, 3), dtype, device, enqueue)


def image_layout(shape) -> tuple[bool, int, int]:
    """(planar, H, W) of one image's samples, [H, W, 3] interleaved or
    [3, H, W] channel-planar. As in the JAX package, a shape is planar when
    its first axis is 3 and its last is not, so [3, H, 3] is interleaved."""
    planar = int(shape[0]) == 3 and int(shape[2]) != 3
    height, width = shape[1:3] if planar else shape[0:2]
    return planar, int(height), int(width)


def interleaved(rgb: torch.Tensor, planar: bool) -> torch.Tensor:
    """Samples [..., 3, H, W] -> [..., H, W, 3] in one copy where they lie;
    interleaved samples as they are."""
    return rgb.movedim(-3, -1).contiguous() if planar else rgb


def mcu_padded_stack(
    pixels_stack: np.ndarray | torch.Tensor,
    maxval: int,
    preset: ChromaSubsamplingPreset,
) -> np.ndarray | torch.Tensor:
    """[B, H, W, 3] or channel-planar [B, 3, H, W] samples pre-padded
    (black) to the preset's MCU multiple, in their own layout: a host
    array is padded here; a tensor must already be padded."""
    b = int(pixels_stack.shape[0])
    planar, height, width = image_layout(pixels_stack.shape[1:])
    ph, pw = padded_size(height, width, preset)
    if (ph, pw) == (height, width):
        return pixels_stack
    if isinstance(pixels_stack, torch.Tensor):
        raise ValueError(f"a slab tensor must be MCU-padded: {height}x{width} -> {ph}x{pw}")
    dtype = narrow_pixels(pixels_stack[:1], maxval).dtype
    if planar:
        padded = np.zeros((b, 3, ph, pw), dtype=dtype)
        padded[:, :, :height, :width] = narrow_pixels(pixels_stack, maxval)
    else:
        padded = np.zeros((b, ph, pw, 3), dtype=dtype)
        padded[:, :height, :width] = narrow_pixels(pixels_stack, maxval)
    return padded


def stacked_rows(stack: torch.Tensor, planar: bool) -> torch.Tensor:
    """An MCU-padded [B, PH, PW, 3] (or planar [B, 3, PH, PW]) stack on the
    device -> its [B * PH, PW, 3] row stack; a planar stack is interleaved."""
    rgb = interleaved(stack, planar)
    return rgb.reshape(-1, int(rgb.shape[2]), 3)


def row_stack(
    pixels_stack: np.ndarray | torch.Tensor,
    maxval: int,
    preset: ChromaSubsamplingPreset,
    device: torch.device | str,
) -> torch.Tensor:
    """[B, H, W, 3] or channel-planar [B, 3, H, W] samples -> the
    [B * PH, PW, 3] row stack of the images pre-padded (black) to the
    preset's MCU multiple, on the device (mcu_padded_stack, uploaded as one
    copy, then stacked_rows)."""
    planar, _, _ = image_layout(pixels_stack.shape[1:])
    stack = mcu_padded_stack(pixels_stack, maxval, preset)
    return stacked_rows(as_device(stack, maxval, device), planar)


def device_phase_batch(
    rgb: torch.Tensor,
    n_images: int,
    maxval: int,
    config: EncoderConfig,
    luma_q: np.ndarray,
    chroma_q: np.ndarray,
    hist_state: torch.Tensor | None = None,
) -> list[torch.Tensor]:
    """The batched device phase of n_images row-stacked, MCU-padded images
    ([B * PH, PW, 3] on the device), enqueued op by op: phase 1 once, DPCM
    per image, grouped histograms -> [luma [B, NL, 64], cb [B, NC, 64], cr
    [B, NC, 64], luma DC [B, 16], luma AC [B, 256], chroma DC [B, 16],
    chroma AC [B, 256]]. What _compiled_pipeline_batch captures and what
    the CPU runs."""
    luma, cb, cr = (x.reshape(n_images, -1, 64) for x in zigzag_blocks(
        rgb, n_images, maxval, luma_q, chroma_q, config.chroma_subsampling, config.dct_variant))
    l_dc, l_ac = batched_symbol_histograms(luma, hist_state)
    c_dc, c_ac = batched_symbol_histograms(torch.cat([cb, cr], dim=1), hist_state)
    return [luma, cb, cr, l_dc, l_ac, c_dc, c_ac]


def run_device_pipeline_batch(
    pixels_stack: np.ndarray | torch.Tensor,
    maxval: int,
    config: EncoderConfig,
    luma_q: np.ndarray,
    chroma_q: np.ndarray,
    device: torch.device | str = "cuda",
) -> tuple[torch.Tensor, ...]:
    """[B, H, W, 3] (or channel-planar [B, 3, H, W]) same-geometry samples
    (mcu_padded_stack's rules: a tensor must be MCU-padded) -> (luma
    [B, NL, 64], cb [B, NC, 64], cr [B, NC, 64], luma DC [B, 16], luma AC
    [B, 256], chroma DC [B, 16], chroma AC [B, 256]) on the device, each
    image's as run_device_pipeline gives them. On a card: one replay of
    the program (_compiled_pipeline_batch), whose instance is held until
    all seven tensors are collected; on the CPU: device_phase_batch."""
    b = int(pixels_stack.shape[0])
    planar, height, width = image_layout(pixels_stack.shape[1:])
    stack = mcu_padded_stack(pixels_stack, maxval, config.chroma_subsampling)
    card = programs.card(stack, device)
    if card is None:
        rgb = stacked_rows(as_device(stack, maxval, device), planar)
        return tuple(device_phase_batch(rgb, b, maxval, config, luma_q, chroma_q))
    pool = _compiled_pipeline_batch(b, height, width, config.chroma_subsampling,
                                    config.dct_variant, planar,
                                    *programs.program_key(stack, maxval, luma_q, chroma_q, card))
    return tuple(programs.start(pool, stack, maxval))


@mode_keyed_cache(maxsize=16)
def _compiled_pipeline_batch(n_images: int, height: int, width: int,
                             preset: ChromaSubsamplingPreset, variant: DCTVariant, planar: bool,
                             device: torch.device, dtype: torch.dtype, maxval: int,
                             luma_key: tuple, chroma_key: tuple):
    """The first half of a fused_batch chunk over an MCU-padded stack: the
    row stack (with the planar interleave), device_phase_batch. Keyed as
    the JAX package's program, plus the group's size and layout (the
    input's shape) and programs.program_key."""
    config = EncoderConfig(chroma_subsampling=preset, dct_variant=variant)
    lq, cq = programs.key_table(luma_key), programs.key_table(chroma_key)
    ph, pw = padded_size(height, width, preset)

    def enqueue(x, state):
        return device_phase_batch(stacked_rows(x, planar), n_images, maxval, config, lq, cq, state)

    shape = (n_images, 3, ph, pw) if planar else (n_images, ph, pw, 3)
    return programs.pool("pipeline_batch", shape, dtype, device, enqueue)
