"""Least times of the port's kernels: the benchmark's roofline arithmetic.

A frozen copy of chip_smoke.py at commit 403a63c (`PEAK_BYTES_S`,
`PEAK_OPS_S`, `OPS_PHASE1_PER_PIXEL`, `OPS_PACK_PER_COEFF` at lines
263-274, `bound` and `pack_bytes` at lines 418-429, and the phase-1 and
scan-pack byte counts at lines 895-900). The work is counted from the
shapes and from the stream's own length, so it is the same whatever
implements a stage.
"""

from __future__ import annotations

# Published H100 SXM peaks at a 700 W limit: HBM bytes/s, and float32 (and
# 32-bit integer) operations/s outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
# Operations per unit of work, counted from the kernels' arithmetic (an fma
# counts as two): phase 1 per pixel (color 20, P420 subsample 4, Arai row +
# column passes with divide and round 11.5 per coefficient x 1.5
# coefficients per pixel); scan pack per coefficient.
OPS_PHASE1_PER_PIXEL = 41
OPS_PACK_PER_COEFF = 30


def bound(n_bytes: float, n_ops: float) -> float:
    """Least time in seconds of work that must move n_bytes and do n_ops."""
    return max(n_bytes / PEAK_BYTES_S, n_ops / PEAK_OPS_S)


def pack_bytes(n_blocks: int, n_images: int, total_bits) -> int:
    """Bytes a scan pack must move: each block read once, each image's four
    tables read once, the stream's words and the bit count written once."""
    words = sum((int(b) + 31) // 32 for b in total_bits)
    return n_blocks * 128 + n_images * (2 * 4 * 256 * 4 + 8) + words * 4


def blocks_per_image(height: int, width: int, hr: int, vr: int) -> int:
    """Luma + Cb + Cr 8x8 blocks of one MCU-padded image."""
    ph, pw = -(-height // (8 * vr)) * 8 * vr, -(-width // (8 * hr)) * 8 * hr
    return (ph // 8) * (pw // 8) + 2 * (ph // (8 * vr)) * (pw // (8 * hr))


def phase1_seconds(height: int, width: int, hr: int, vr: int) -> float:
    """Least time of phase 1 for one 8-bit image: its samples read, its int16
    blocks and two float32 tables moved once, 41 operations per pixel."""
    n_blocks = blocks_per_image(height, width, hr, vr)
    return bound(height * width * 3 + n_blocks * 128 + 2 * 64 * 4,
                 height * width * OPS_PHASE1_PER_PIXEL)


def scan_pack_seconds(height: int, width: int, hr: int, vr: int, total_bits: int) -> float:
    """Least time of one image's scan pack of a stream of total_bits."""
    n_blocks = blocks_per_image(height, width, hr, vr)
    return bound(pack_bytes(n_blocks, 1, [total_bits]), n_blocks * 64 * OPS_PACK_PER_COEFF)
