"""Scan-pack kernel wrappers: scan-order blocks -> packed bitstream words.

Counterpart of dmmt_jpeg_encoder_tpu.bitstream.fused_pack
(`fused_pack_words`, `fused_pack_words_slab`). The CUDA kernel is
csrc/scan_pack.cu (three launches: block bit lengths, a device-wide
exclusive scan of the block offsets, emission with atomicOr); its slab
entry point runs the same launches over B images at once. The plain
versions are device_pack.pack_scan_plain (block_emissions + pack_to_words
+ byteswap_words) and device_pack.pack_scan_slab_plain. The TPU kernel
swept compacted present-symbol tables from SMEM; here the four flat
(code, length) tables sit whole in shared memory.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from ..kernels import build
from .device_pack import pack_scan_plain, pack_scan_slab_plain

CHUNK = 256  # blocks per CTA in csrc/scan_pack.cu


def fused_pack_words(
    scan: torch.Tensor,
    stride: int,
    luma_per_mcu: int,
    codes_flat: torch.Tensor,
    lens_flat: torch.Tensor,
    n_words: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """int16 [N, 64] scan-order blocks (DC DPCM'd; block i is chroma iff
    i % stride >= luma_per_mcu) + int32 [4, 256] flat tables (luma DC,
    luma AC, chroma DC, chroma AC) -> (words int32 [n_words] holding the
    stream's uint32 words in memory byte order, total_bits int64 [1]).
    n_words must cover the worst case, N * 64 + 2."""
    n = int(scan.shape[0])
    if n_words < n * 64 + 2:
        raise ValueError(f"n_words {n_words} below the worst case {n * 64 + 2}")
    if scan.device.type == "cpu":
        return pack_scan_plain(scan, stride, luma_per_mcu, codes_flat, lens_flat, n_words)
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
    n_chunks = -(-n // CHUNK)
    words = torch.zeros(n_words, dtype=torch.int32, device=dev)
    block_bits = torch.empty(n, dtype=torch.int32, device=dev)
    chunk_sums = torch.empty(n_chunks, dtype=torch.int64, device=dev)
    chunk_base = torch.empty(n_chunks, dtype=torch.int64, device=dev)
    total_bits = torch.empty(1, dtype=torch.int64, device=dev)
    lib = build.load()
    err = lib.dmmt_scan_pack(
        scan.data_ptr(), n, stride, luma_per_mcu, codes.data_ptr(), lens.data_ptr(),
        block_bits.data_ptr(), chunk_sums.data_ptr(), chunk_base.data_ptr(),
        words.data_ptr(), n_words, total_bits.data_ptr(),
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
) -> tuple[torch.Tensor, torch.Tensor]:
    """B independent streams in one kernel call: int16 [B, N, 64] scans
    (each image's blocks, DC DPCM'd per image) + int32 [B, 4, 256] per-image
    tables -> (words int32 [B, n_words], total_bits int64 [B]). Image b's
    row equals fused_pack_words on its own scan and tables. n_words is per
    image and must cover the worst case, N * 64 + 2."""
    if scans.ndim != 3 or scans.shape[2] != 64 or scans.shape[0] == 0 or scans.shape[1] == 0:
        raise ValueError(f"expected [B, N, 64] scans, got {tuple(scans.shape)}")
    b, n = int(scans.shape[0]), int(scans.shape[1])
    if n_words < n * 64 + 2:
        raise ValueError(f"n_words {n_words} below the worst case {n * 64 + 2}")
    if codes.shape != (b, 4, 256) or lens.shape != (b, 4, 256):
        raise ValueError(f"expected [{b}, 4, 256] code and length tables")
    if scans.device.type == "cpu":
        return pack_scan_slab_plain(scans, stride, luma_per_mcu, codes, lens, n_words)
    if scans.device.type != "cuda":
        raise ValueError(f"slab scan-pack kernel needs a CUDA tensor, got {scans.device}")
    if scans.dtype != torch.int16:
        raise ValueError(f"expected int16 scans, got {scans.dtype}")
    dev = scans.device
    scans = scans.contiguous()
    codes = codes.to(device=dev, dtype=torch.int32).contiguous()
    lens = lens.to(device=dev, dtype=torch.int32).contiguous()
    n_chunks = -(-n // CHUNK)
    words = torch.zeros((b, n_words), dtype=torch.int32, device=dev)
    block_bits = torch.empty((b, n), dtype=torch.int32, device=dev)
    chunk_sums = torch.empty((b, n_chunks), dtype=torch.int64, device=dev)
    chunk_base = torch.empty((b, n_chunks), dtype=torch.int64, device=dev)
    total_bits = torch.empty(b, dtype=torch.int64, device=dev)
    lib = build.load()
    err = lib.dmmt_scan_pack_slab(
        scans.data_ptr(), b, n, stride, luma_per_mcu, codes.data_ptr(), lens.data_ptr(),
        block_bits.data_ptr(), chunk_sums.data_ptr(), chunk_base.data_ptr(),
        words.data_ptr(), n_words, total_bits.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(err, "dmmt_scan_pack_slab")
    build.LAUNCHES["scan_pack_slab"] += 1
    return words, total_bits
