"""Scan-pack kernel wrappers: scan-order blocks -> packed bitstream words.

Counterpart of dmmt_jpeg_encoder_tpu.bitstream.fused_pack
(`fused_pack_words`, `fused_pack_words_slab`). The CUDA kernel is
csrc/scan_pack.cu (one launch over 128-block tiles: each tile codes its
blocks, finds its bit offset by decoupled look-back over the tiles before
it, and assembles its words in shared memory); its slab entry point runs
the same launch over B images at once. Each call zeroes the word buffer
and, behind it in the same fill, the tiles' look-back states
(zeroed_buffers). The plain
versions are device_pack.pack_scan_plain (block_emissions + pack_to_words
+ byteswap_words) and device_pack.pack_scan_slab_plain. The TPU kernel
swept compacted present-symbol tables from SMEM; here the four flat
(code, length) tables sit whole in shared memory.

Both take the TPU kernels' optional `valid` mask (int [N], or [B, N] for
the slab): an invalid block contributes 0 bits and emits nothing. The
sharded encode passes it to leave out each shard's alignment blocks.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from ..kernels import build
from .device_pack import pack_scan_plain, pack_scan_slab_plain

TILE = 128  # blocks per CTA in csrc/scan_pack.cu


def zeroed_buffers(n_images: int, n_words: int, n_blocks: int, dev: torch.device,
                   tile: int = TILE) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One zero fill for the words (int32 [n_images, n_words]) and, behind
    them, the kernel's look-back state (int64 [n_images, ceil(n_blocks /
    tile) + 1]): (the whole buffer, words, state). The words are a view of
    the buffer's head."""
    head = n_images * n_words + (n_images * n_words) % 2  # the state starts 8-byte aligned
    n_state = n_images * (-(-n_blocks // tile) + 1)
    buf = torch.zeros(head + 2 * n_state, dtype=torch.int32, device=dev)
    words = buf[: n_images * n_words].view(n_images, n_words)
    return buf, words, buf[head:].view(torch.int64).view(n_images, -1)


def _mask_arg(valid: torch.Tensor | None, dev: torch.device) -> torch.Tensor | None:
    """The kernel's int32 mask on `dev` (None: no mask)."""
    if valid is None:
        return None
    if valid.device != dev:
        raise ValueError(f"valid mask on {valid.device}, blocks on {dev}")
    return valid.to(torch.int32).contiguous()


def fused_pack_words(
    scan: torch.Tensor,
    stride: int,
    luma_per_mcu: int,
    codes_flat: torch.Tensor,
    lens_flat: torch.Tensor,
    n_words: int,
    valid: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """int16 [N, 64] scan-order blocks (DC DPCM'd; block i is chroma iff
    i % stride >= luma_per_mcu) + int32 [4, 256] flat tables (luma DC,
    luma AC, chroma DC, chroma AC) -> (words int32 [n_words] holding the
    stream's uint32 words in memory byte order, total_bits int64 [1]).
    n_words must cover the worst case, N * 64 + 2. `valid` (int or bool
    [N], nonzero = packed) leaves the other blocks out of the stream."""
    n = int(scan.shape[0])
    if n_words < n * 64 + 2:
        raise ValueError(f"n_words {n_words} below the worst case {n * 64 + 2}")
    if valid is not None and tuple(valid.shape) != (n,):
        raise ValueError(f"expected a [{n}] valid mask, got {tuple(valid.shape)}")
    if scan.device.type == "cpu":
        return pack_scan_plain(scan, stride, luma_per_mcu, codes_flat, lens_flat, n_words, valid)
    if scan.device.type != "cuda":
        raise ValueError(f"scan-pack kernel needs a CUDA tensor, got {scan.device}")
    if scan.dtype != torch.int16 or scan.ndim != 2 or scan.shape[1] != 64 or n == 0:
        raise ValueError(f"expected int16 [N, 64] blocks, got {scan.dtype} {tuple(scan.shape)}")
    dev = scan.device
    scan = scan.contiguous()
    codes = codes_flat.to(device=dev, dtype=torch.int32).contiguous()
    lens = lens_flat.to(device=dev, dtype=torch.int32).contiguous()
    if codes.shape != (4, 256) or lens.shape != (4, 256):
        raise ValueError("expected [4, 256] code and length tables")
    mask = _mask_arg(valid, dev)
    _, words, state = zeroed_buffers(1, n_words, n, dev)
    words = words[0]
    total_bits = torch.empty(1, dtype=torch.int64, device=dev)
    lib = build.load()
    err = lib.dmmt_scan_pack(
        scan.data_ptr(), n, stride, luma_per_mcu, codes.data_ptr(), lens.data_ptr(),
        None if mask is None else mask.data_ptr(), state.data_ptr(), words.data_ptr(),
        n_words, total_bits.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(err, "dmmt_scan_pack")
    build.LAUNCHES["scan_pack"] += 1
    return words, total_bits


def fused_pack_words_slab(
    scans: torch.Tensor,
    stride: int,
    luma_per_mcu: int,
    codes: torch.Tensor,
    lens: torch.Tensor,
    n_words: int,
    valid: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """B independent streams in one kernel call: int16 [B, N, 64] scans
    (each image's blocks, DC DPCM'd per image) + int32 [B, 4, 256] per-image
    tables -> (words int32 [B, n_words], total_bits int64 [B]). Image b's
    row equals fused_pack_words on its own scan, tables and valid[b]
    (`valid`: int or bool [B, N], or None). n_words is per image and must
    cover the worst case, N * 64 + 2."""
    if scans.ndim != 3 or scans.shape[2] != 64 or scans.shape[0] == 0 or scans.shape[1] == 0:
        raise ValueError(f"expected [B, N, 64] scans, got {tuple(scans.shape)}")
    b, n = int(scans.shape[0]), int(scans.shape[1])
    if n_words < n * 64 + 2:
        raise ValueError(f"n_words {n_words} below the worst case {n * 64 + 2}")
    if codes.shape != (b, 4, 256) or lens.shape != (b, 4, 256):
        raise ValueError(f"expected [{b}, 4, 256] code and length tables")
    if valid is not None and tuple(valid.shape) != (b, n):
        raise ValueError(f"expected a [{b}, {n}] valid mask, got {tuple(valid.shape)}")
    if scans.device.type == "cpu":
        return pack_scan_slab_plain(scans, stride, luma_per_mcu, codes, lens, n_words, valid)
    if scans.device.type != "cuda":
        raise ValueError(f"slab scan-pack kernel needs a CUDA tensor, got {scans.device}")
    if scans.dtype != torch.int16:
        raise ValueError(f"expected int16 scans, got {scans.dtype}")
    dev = scans.device
    scans = scans.contiguous()
    codes = codes.to(device=dev, dtype=torch.int32).contiguous()
    lens = lens.to(device=dev, dtype=torch.int32).contiguous()
    mask = _mask_arg(valid, dev)
    _, words, state = zeroed_buffers(b, n_words, n, dev)
    total_bits = torch.empty(b, dtype=torch.int64, device=dev)
    lib = build.load()
    err = lib.dmmt_scan_pack_slab(
        scans.data_ptr(), b, n, stride, luma_per_mcu, codes.data_ptr(), lens.data_ptr(),
        None if mask is None else mask.data_ptr(), state.data_ptr(), words.data_ptr(),
        n_words, total_bits.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(err, "dmmt_scan_pack_slab")
    build.LAUNCHES["scan_pack_slab"] += 1
    return words, total_bits
