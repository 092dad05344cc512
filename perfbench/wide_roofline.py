"""Least times of port kernels that perfbench/roofline.py does not count:
phase 1 (K1) on samples of any width at any subsampling, and the byte
stuffing behind the scan pack (K13, `stuff_kernel`), with their readers.

roofline.phase1_seconds is a frozen count for 8-bit P420 input: 1-byte
samples and 41 operations a pixel. Here phase 1 reads h * w * 3 samples
of `sample_bytes` each, writes its int16 blocks and reads its two float32
tables once, and does per pixel 20 operations of color conversion, 4 of
subsampling where the chroma is subsampled, and 11.5 a coefficient
(Arai row and column passes with divide and round) over the coefficients
of a pixel, 1 + 2 / (hr * vr): 54.5 at 4:4:4. The stuffing reads the
packed stream once and writes the stuffed stream once; the stream's
length comes from the JPEG (Trace.scan_bits, unstuffed), so the stuffed
stream is counted at that length, without the 0x00 after each 0xFF
(about one byte in 256 of a photograph's stream): a least time a little
low, never high. Both are counted from the shapes and the stream, so they
are the same whatever implements a stage.
"""

from __future__ import annotations

from perfbench.roofline import PEAK_BYTES_S, blocks_per_image, bound
from perfbench.trace import kernel_base

OPS_COLOR_PER_PIXEL = 20
OPS_SUBSAMPLE_PER_PIXEL = 4
OPS_DCT_PER_COEFF = 11.5


def phase1_ops_per_pixel(hr: int, vr: int) -> float:
    """Phase 1's operations a pixel at horizontal and vertical chroma rates
    hr, vr."""
    subsample = 0 if hr * vr == 1 else OPS_SUBSAMPLE_PER_PIXEL
    return OPS_COLOR_PER_PIXEL + subsample + OPS_DCT_PER_COEFF * (1 + 2 / (hr * vr))


def phase1_seconds(height: int, width: int, hr: int, vr: int, sample_bytes: int) -> float:
    """Least time of phase 1 for one image of samples of sample_bytes bytes."""
    n_blocks = blocks_per_image(height, width, hr, vr)
    return bound(height * width * 3 * sample_bytes + n_blocks * 128 + 2 * 64 * 4,
                 height * width * phase1_ops_per_pixel(hr, vr))


def stuff_seconds(total_bits: int) -> float:
    """Least time of one stream's stuffing: its ceil(total_bits / 8) bytes
    read once and written once."""
    n_bytes = (int(total_bits) + 7) // 8
    return 2 * n_bytes / PEAK_BYTES_S


def sample_bytes(kernel_name: str) -> int:
    """The sample width of a phase-1 kernel from its template argument:
    `phase1_kernel<1, 1, unsigned short>` reads 2-byte samples."""
    return 2 if "unsigned short" in kernel_name else 1


def _kernels(t, base: str) -> list:
    """The traced stretch's kernels whose __global__ function is `base`."""
    return [k for k in t.kernels if k.end > t.start and k.start < t.end and kernel_base(k.name) == base]


def _seconds(kernels: list) -> float:
    return sum(k.end - k.start for k in kernels) / 1e6


def phase1_roofline(run) -> float | None:
    """Percent: least time of phase 1 over the traced images, at the
    sample width its kernel was built for, over the kernel's measured
    time; nothing where the trace holds no phase-1 kernel."""
    t = run.trace
    kernels = _kernels(t, "phase1_kernel") if t is not None else []
    if not _seconds(kernels):
        return None
    width = max(sample_bytes(k.name) for k in kernels)
    return 100.0 * t.images * phase1_seconds(*t.shape, width) / _seconds(kernels)


def scan_stuff_roofline(run) -> float | None:
    """Percent: least time of the traced images' stuffing (each from its
    stream's length), over the stuffing kernel's measured time; nothing
    where the trace holds no `stuff_kernel` (a program that stuffs on the
    host)."""
    t = run.trace
    kernels = _kernels(t, "stuff_kernel") if t is not None else []
    if not _seconds(kernels) or not t.scan_bits:
        return None
    return 100.0 * sum(stuff_seconds(b) for b in t.scan_bits) / _seconds(kernels)
