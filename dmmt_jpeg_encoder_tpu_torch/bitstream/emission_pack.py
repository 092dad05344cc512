"""Emission-pack kernel wrapper: per-block emission triples -> stream words.

Counterpart of dmmt_jpeg_encoder_tpu.bitstream.pallas_pack
(`pallas_pack_words`: its fragment kernel and its merge kernel). The CUDA
kernel is csrc/emission_pack.cu, one launch for both TPU kernels: the
fragment/merge split worked around Mosaic's lack of a scatter: one CTA
per tile of 32 blocks assembles the tile's words in shared memory and
stores them once; the last tile also writes the total bit count. Its
plain version is device_pack.pack_to_words. The TPU wrapper rounded the
word buffer up to a power of two of its staging rows (pack_words_capacity);
here the caller sizes it as the words it needs + 2, zeroed here, so words
in the gaps between images read 0.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from ..kernels import build
from .device_pack import N_SLOTS, block_offsets, pack_to_words


def pack_emission_words(
    values: torch.Tensor,
    lens: torch.Tensor,
    offs: torch.Tensor,
    block_bits: torch.Tensor,
    n_words: int,
    boff: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """int32 [N, 68] emission values, bit lengths and block-relative bit
    offsets (device_pack.block_emissions) + int [N] block bit lengths ->
    (words int32 [n_words], the logical big-endian uint32 words as bit
    patterns; total_bits int64 scalar). `boff` (int [N], nondecreasing)
    overrides the exclusive scan of block_bits as each block's stream bit
    offset: the fused batch places each image at a word-aligned base."""
    n = int(values.shape[0])
    if n == 0 or values.shape != (n, N_SLOTS) or lens.shape != values.shape \
            or offs.shape != values.shape or block_bits.shape != (n,):
        raise ValueError(f"expected [N, {N_SLOTS}] emissions and [N] block bits, got "
                         f"{tuple(values.shape)}, {tuple(lens.shape)}, {tuple(offs.shape)}, "
                         f"{tuple(block_bits.shape)}")
    if boff is not None and boff.shape != (n,):
        raise ValueError(f"expected [{n}] block offsets, got {tuple(boff.shape)}")
    if values.device.type == "cpu":
        return pack_to_words(values, lens, offs, block_bits, n_words, boff)
    if values.device.type != "cuda":
        raise ValueError(f"emission-pack kernel needs a CUDA tensor, got {values.device}")
    dev = values.device
    if boff is None:
        boff = block_offsets(block_bits)[0]
    val, ln, off, bits = (x.to(device=dev, dtype=torch.int32).contiguous()
                          for x in (values, lens, offs, block_bits))
    boff = boff.to(device=dev, dtype=torch.int64).contiguous()
    words = torch.zeros(n_words, dtype=torch.int32, device=dev)
    total_bits = torch.empty((), dtype=torch.int64, device=dev)
    lib = build.load()
    err = lib.dmmt_pack_emissions(
        val.data_ptr(), ln.data_ptr(), off.data_ptr(), boff.data_ptr(), bits.data_ptr(), n,
        words.data_ptr(), n_words, total_bits.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(err, "dmmt_pack_emissions")
    build.LAUNCHES["pack_emissions"] += 1
    return words, total_bits
