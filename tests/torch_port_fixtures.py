"""Fixture images shared by the PyTorch-port tests and chip_smoke.py.

The pixels are built with integer-only numpy (default_rng(seed).integers
and integer gradients, no floating point), so every machine builds the
same bytes. `torch_port_goldens.json` holds, per fixture, the sha256 of
the pixels and of the JAX package's `encode_array` bytes on the CPU: the
machine with the GPU has no JAX, so the port's output there is held
against these digests. Batch fixtures (`BATCH_FIXTURES`, under the key
"batches") hold the same per frame; frame i of a batch is built from the
batch's seed + i, so every frame differs. Under "routes", the same per
fixture for each phase-1 route of `ROUTES` (a DMMT_P1 value or a DCT
variant; the `HIGH_ROUTES` also under DMMT_P1_PREC=high), and under
"route_batches" the frames of the batches named in
`ROUTE_BATCHES`.

Regenerate the goldens (needs the JAX package) with

    JAX_PLATFORMS=cpu python tests/torch_port_fixtures.py
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
from pathlib import Path

import numpy as np

GOLDENS_PATH = Path(__file__).with_name("torch_port_goldens.json")

if "PYTEST_XDIST_WORKER_COUNT" in os.environ:
    # Each pytest-xdist worker's torch intra-op pool gets its share of the
    # cores it may run on: six workers with a pool of every core each
    # oversubscribe the machine several times over. Every worker imports
    # this module while it collects. XLA:CPU's pool is left as it is:
    # single-threaded Eigen sums the reference's dots in another order.
    import torch

    torch.set_num_threads(max(1, len(os.sched_getaffinity(0))
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))

# name -> geometry, sample range, preset and quality of the encode
FIXTURES: dict[str, dict] = {
    "4k_p420": dict(height=2160, width=3840, maxval=255, preset="P420", quality=None, seed=0),
    "333x1001_p422": dict(height=333, width=1001, maxval=255, preset="P422", quality=75, seed=1),
    "7x17_p444": dict(height=7, width=17, maxval=255, preset="P444", quality=None, seed=2),
    "123x205_maxval4095_p420": dict(
        height=123, width=205, maxval=4095, preset="P420", quality=None, seed=3
    ),
}
SMALL_FIXTURES = [name for name in FIXTURES if name != "4k_p420"]

# name -> n frames of one geometry, sample range, preset and quality
BATCH_FIXTURES: dict[str, dict] = {
    "batch_1080p_p420": dict(n=16, height=1080, width=1920, maxval=255, preset="P420",
                             quality=None, seed=100),
    "batch_4k_p420": dict(n=4, height=2160, width=3840, maxval=255, preset="P420",
                          quality=None, seed=200),
    "batch_odd_p422": dict(n=3, height=45, width=71, maxval=255, preset="P422",
                           quality=90, seed=300),
}


# route -> (DMMT_P1 value or None, DCT variant): the phase-1 routes besides
# the default (DMMT_P1=plane, ARAI)
ROUTES: dict[str, tuple[str | None, str]] = {
    "p1_pallas": ("pallas", "arai"),
    "p1_mxu": ("mxu", "arai"),
    "p1_fused1": ("fused1", "arai"),
    "dct_simple": (None, "simple"),
    "dct_separated": (None, "separated"),
    "dct_fused": (None, "fused"),
    "p1_mxu_high": ("mxu", "arai"),
    "p1_fused1_high": ("fused1", "arai"),
}
# the routes run with DMMT_P1_PREC=high (the others with it unset)
HIGH_ROUTES = ("p1_mxu_high", "p1_fused1_high")
# route -> batch fixtures with goldens under it
ROUTE_BATCHES: dict[str, list[str]] = {
    "p1_mxu": ["batch_1080p_p420"],
    "dct_fused": ["batch_1080p_p420"],
}


@contextlib.contextmanager
def route_env(route: str | None):
    """DMMT_P1 and DMMT_P1_PREC as `route` sets them (each unset where the
    route does not set it: DMMT_P1 for a DCT-variant route or None,
    DMMT_P1_PREC outside HIGH_ROUTES), restored after the block."""
    names = ("DMMT_P1", "DMMT_P1_PREC")
    saved = {k: os.environ.pop(k, None) for k in names}
    mode = ROUTES[route][0] if route else None
    if mode:
        os.environ["DMMT_P1"] = mode
    if route in HIGH_ROUTES:
        os.environ["DMMT_P1_PREC"] = "high"
    try:
        yield
    finally:
        for k in names:
            os.environ.pop(k, None)
            if saved[k] is not None:
                os.environ[k] = saved[k]


def fixture_pixels(name: str) -> np.ndarray:
    f = FIXTURES[name]
    return _pixels(f["height"], f["width"], f["maxval"], f["seed"])


def batch_frames(name: str) -> list[np.ndarray]:
    f = BATCH_FIXTURES[name]
    return [_pixels(f["height"], f["width"], f["maxval"], f["seed"] + i) for i in range(f["n"])]


def _pixels(h: int, w: int, maxval: int, seed: int) -> np.ndarray:
    """RGB [H, W, 3] samples: a ramp, hard-edged tiles and a sawtooth
    texture, plus per-channel noise; uint8, or uint16 when maxval > 255."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.int64)
    ramp = 40 + (xx * 150) // max(w - 1, 1) + (yy * 50) // max(h - 1, 1)
    tiles = ((xx // 53 + yy // 31) % 3) * 12
    wave = ((xx * 7 + yy * 3) % 64 - 32) // 4
    base = ramp + tiles + wave - 12
    rgb = base[..., None] + np.array([0, -10, 12]) + rng.integers(-8, 9, size=(h, w, 3))
    rgb = np.clip(rgb, 0, 255)
    if maxval <= 255:
        return rgb.astype(np.uint8)
    scale = (maxval + 1) // 256
    fine = rng.integers(0, scale, size=(h, w, 3))
    return np.clip(rgb * scale + fine, 0, maxval).astype(np.uint16)


# PSNR floor, dB, of the 4k_p420 golden JPEG decoded by the port's
# debug.jpeg_decoder against the fixture's pixels: the decode measures
# 32.627 dB (test_torch_tooling.py, on the CPU); chip_smoke.py decodes the
# card's JPEG and fails below this floor.
DECODE_PSNR_FLOOR_4K = 32.6


def psnr(decoded: np.ndarray, pixels: np.ndarray, maxval: int = 255) -> float:
    """PSNR in dB of 8-bit decoded samples against source samples of
    `maxval` (scaled to 8 bits as the encoder normalizes them)."""
    ref = pixels.astype(np.float64) * (255.0 / maxval)
    mse = ((decoded.astype(np.float64) - ref) ** 2).mean()
    return float("inf") if mse == 0 else float(10 * np.log10(255.0**2 / mse))


def random_blocks(seed: int, n: int = 600) -> np.ndarray:
    """int16 [n, 64] zigzag blocks with photographic sparsity: a large DC,
    AC magnitudes falling with frequency, long zero runs (ZRLs), some
    all-zero and some fully dense blocks."""
    rng = np.random.default_rng(seed)
    scale = 200.0 / (1.0 + np.arange(64)) ** 1.2
    vals = np.round(rng.standard_normal((n, 64)) * scale).astype(np.int64)
    keep = rng.random((n, 64)) < np.linspace(0.9, 0.05, 64)
    blocks = np.where(keep, vals, 0)
    blocks[:, 0] = rng.integers(-1024, 1024, n)
    blocks[: n // 20, 1:] = 0
    blocks[n // 20 : n // 10, 1:] = rng.integers(-900, 900, (n // 10 - n // 20, 63))
    blocks[-7:, 1:] = 0
    blocks[-7:, 63] = rng.integers(1, 5, 7)
    return blocks.astype(np.int16)


# Edge shapes of the tilings of the block DCT kernel and the table lookup
# kernel, shared by tests/test_torch_kernel_edges.py (the plain versions
# against the JAX functions) and chip_smoke.py (the kernels against the
# plain versions on the card). BLOCK_DCT_TILE is the block DCT kernel's
# tile of blocks (TILE in dmmt_jpeg_encoder_tpu_torch/csrc/block_dct.cu).
BLOCK_DCT_TILE = 128
BLOCK_DCT_EDGE_N = (1, BLOCK_DCT_TILE - 1, BLOCK_DCT_TILE, BLOCK_DCT_TILE + 1,
                    3 * BLOCK_DCT_TILE + 5)
# (G, m, T): m around the lookup kernel's four-entry (int4) vectors, so that
# every row after the first starts unaligned when m % 4 != 0
LOOKUP_EDGE_K = 3000
LOOKUP_EDGE_SHAPES = tuple(
    (g, m, t)
    for g in (1, 3, 16)
    for m in (1, 3, 5, 4 * LOOKUP_EDGE_K + 1, 4 * LOOKUP_EDGE_K + 2, 4 * LOOKUP_EDGE_K + 3)
    for t in (1, 32, 512)
)


def block_dct_edge_inputs(n: int) -> tuple[np.ndarray, np.ndarray]:
    """float32 [n, 8, 8] level-shifted samples in sixteenths (exact in
    float32) and a raster quantization table [64] (uint16, 1..63)."""
    rng = np.random.default_rng(1000 + n)
    blocks = (rng.integers(-128 * 16, 128 * 16, (n, 8, 8)) / 16).astype(np.float32)
    return blocks, rng.integers(1, 64, 64).astype(np.uint16)


def lookup_edge_inputs(g: int, m: int, t: int, in_range: bool) -> tuple[np.ndarray, np.ndarray]:
    """int32 [g, m] symbols and uint32 [g, t] tables of (code << 8 | len)
    words below 2^24. With in_range False the symbols also hold -1, t and
    t + 1 (each row starts with -1 and ends with t)."""
    rng = np.random.default_rng((g * 1009 + m) * 1013 + t)
    tables = rng.integers(0, 1 << 24, (g, t)).astype(np.uint32)
    if in_range:
        return rng.integers(0, t, (g, m)).astype(np.int32), tables
    symbols = rng.integers(-1, t + 2, (g, m)).astype(np.int32)
    symbols[:, 0], symbols[:, -1] = -1, t
    return symbols, tables


# Edge shapes of the scan-pack kernel's tiling and of its coding, shared the
# same way. SCAN_PACK_TILE and SCAN_PACK_TILE_WORDS are TILE and TILE_WORDS
# in dmmt_jpeg_encoder_tpu_torch/csrc/scan_pack.cu: a tile of blocks per
# CTA, and the shared word buffer past which a tile takes the over-full arm.
SCAN_PACK_TILE = 128
SCAN_PACK_TILE_WORDS = 2048
# case -> (blocks, stride, luma blocks per MCU): scan-order int16 zigzag
# blocks, DC already DPCM'd (block i is chroma iff i % stride >= lpm)
SCAN_PACK_EDGE_CASES = (
    "n1", "tile-1", "tile", "tile+1", "tiles3+5", "no_ac", "all_ac", "zero_runs", "only_63",
    "extreme", "overfull",
)
# the `valid` masks, each on the case of three tiles and five
SCAN_PACK_EDGE_MASKS = ("all", "none", "alternating", "single")
# the slab scan pack's images (B = 1 and 3), each a case of three tiles and
# five blocks with its own tables
SCAN_PACK_SLAB_EDGES = (("extreme",), ("tiles3+5", "zero_runs", "overfull"))
# Edge cases of the stuffing kernel (csrc/scan_stuff.cu), shared the same
# way. STUFF_CHUNK is its CHUNK (stream bytes a chunk; a thread reads 16):
# every 1-pad of the last byte, an all-0xFF stream over three chunks (its
# stuffed copy twice as long), a 0xFF made by the 1-pad alone, a 0xFF at
# each offset in a word and on both sides of thread and chunk edges, an
# empty stream, slab rows of different lengths, and rows whose tail is too
# short for the stuffed copy (the host stuffs those: length -1).
STUFF_CHUNK = 4096
STUFF_EDGE_CASES = (
    "pad0", "pad1", "pad2", "pad3", "pad4", "pad5", "pad6", "pad7", "all_ff", "pad_makes_ff",
    "ff_offsets", "empty", "slab_rows", "short_tail", "short_slab_row",
)


# (height, width, preset, maxval) of the phase-1 kernel's strip tiling:
# widths whose rows are not whole 16-byte chunks (7x17, 9x35, 333x1001),
# each preset, 16-bit samples and a one-level range
PHASE1_EDGE_CASES = tuple(
    (h, w, p, 255) for h, w in ((1, 1), (7, 17), (8, 8), (15, 16), (9, 35), (333, 1001))
    for p in ("P444", "P422", "P420")
) + ((15, 16, "P420", 4095), (15, 16, "P420", 65535), (9, 35, "P422", 65535),
     (15, 16, "P420", 1), (9, 35, "P444", 1))


# Edge cases of the block-histogram kernel (csrc/block_hist.cu), shared the
# same way: (content, segment sizes, n_valid or None for all). Block counts
# around its warps' groups of 4 blocks, each with the prefixes 0, 1, N - 1
# and N; the coding corners of the scan-pack cases (blocks with no AC, all
# 63 AC, only position 63, zero runs of 15-48, DC category 11 and AC
# category 10); chroma calls of two segments of unequal and odd lengths,
# with prefixes that end in either segment.
BLOCK_HIST_EDGE_N = (1, 7, 8, 9, 127, 128, 129, 389)
BLOCK_HIST_EDGE_CASES = tuple(
    ("random", (n,), nv) for n in BLOCK_HIST_EDGE_N for nv in sorted({0, 1, n - 1, n})
) + tuple(
    (content, (3 * SCAN_PACK_TILE + 5,), None)
    for content in ("no_ac", "all_ac", "only_63", "zero_runs", "extreme")
) + tuple(
    ("random", sizes, None) for sizes in ((1, 0), (0, 7), (9, 4), (129, 127), (389, 1), (7, 389))
) + (("random", (129, 127), 50), ("random", (129, 127), 200), ("extreme", (389, 129), 300))


# Edge shapes of the matmul plane DCT (csrc/mxu_dct.cu, two threads per 8x8
# group), shared the same way: widths of 1, 15, 16, 17 and 241 groups
# (around the kernel's 64-group CTAs when rows are few), heights of one and
# three group rows, and Cb and Cr of an 80 x 144 P420 frame stacked, as the
# route stacks them (with a table past 8 bits).
PLANE_MM_EDGE_SHAPES = tuple(
    (h, w) for h in (8, 24) for w in (8, 120, 128, 136, 1928)
) + ((2 * 40, 72),)


def plane_mm_edge_inputs(h: int, w: int) -> tuple[np.ndarray, np.ndarray]:
    """float32 [h, w] level-shifted plane and a raster quantization table
    [64] (uint16). Group g (raster order) is, by g % 5: random sixteenths
    in [-128, 128); flat -128 and flat 127 (saturated); a flat odd integer
    a, whose DC lands on a / 2 = x.5 after / q[0] = 16 up to the
    contractions' rounding; a checkerboard of -128 and 127 (the largest
    AC). q also holds 1 (a division that is exact) and 255; the stacked
    chroma shape's also 300 and 1000, past the 8-bit tables the encoder
    makes (the kernel's arm for any other table)."""
    rng = np.random.default_rng(h * 10007 + w)
    groups = rng.integers(-128 * 16, 128 * 16, (h // 8, w // 8, 8, 8)) / 16
    kind = np.arange((h // 8) * (w // 8)).reshape(h // 8, w // 8) % 5
    odd = rng.integers(-64, 64, groups.shape[:2]) * 2 + 1
    checker = np.where((np.arange(8)[:, None] + np.arange(8)) % 2, 127.0, -128.0)
    groups[kind == 1] = -128.0
    groups[kind == 2] = 127.0
    groups[kind == 3] = odd[kind == 3][:, None, None]
    groups[kind == 4] = checker
    plane = groups.transpose(0, 2, 1, 3).reshape(h, w).astype(np.float32)
    q = rng.integers(1, 256, 64).astype(np.uint16)
    q[0], q[1], q[8] = 16, 1, 255
    if (h, w) == PLANE_MM_EDGE_SHAPES[-1]:
        q[2], q[3] = 300, 1000
    return plane, q


# Edge shapes of the Arai plane DCT (csrc/plane_dct.cu), shared the same way:
# the matmul plane DCT's shapes and inputs (plane_mm_edge_inputs: saturated
# groups, flat odd groups whose DC lands on x.5 after / q[0] = 16, the
# largest AC, a table past 8 bits on the stacked chroma shape), since the
# two kernels split the plane alike (two threads per 8x8 group).
PLANE_DCT_EDGE_SHAPES = PLANE_MM_EDGE_SHAPES


# Edge cases of the weighted histogram (csrc/histogram.cu), shared the same
# way: (G, M, n_bins, content). M of 0, 1, 3, 4, 5 and an odd few hundred
# around the kernel's 16-byte quads; G of 3 and 16 with M % 4 != 0, so that
# every row after the first starts unaligned; n_bins of 1, 16 and 256;
# rows past the kernel's step of 2048 quads a CTA. content:
# - "in_range": symbols in [0, n_bins), weights 0, 1, up to 1000 and
#   negative;
# - "out_of_range": also symbols below 0 and at or past n_bins (each row
#   starts with -1 and ends with n_bins), small weights (the TPU kernel
#   sums a tile in float32);
# - "past_2_24": every entry of a row in one bin with weights near 1000, so
#   that the bin's count passes 2^24 (where float32 would round).
HISTOGRAM_EDGE_CASES = tuple(
    (1, m, n, "in_range") for m in (0, 1, 3, 4, 5, 389) for n in (1, 16, 256)
) + tuple(
    (g, m, n, "in_range") for g in (3, 16) for m in (5, 389) for n in (16, 256)
) + (
    (1, 40_001, 16, "past_2_24"), (3, 20_003, 256, "past_2_24"),
    (1, 2_500_003, 256, "in_range"), (3, 300_001, 16, "in_range"),
    (1, 389, 1, "out_of_range"), (1, 389, 16, "out_of_range"), (1, 389, 256, "out_of_range"),
    (3, 389, 16, "out_of_range"), (16, 5, 256, "out_of_range"), (3, 5, 1, "out_of_range"),
)


def histogram_edge_inputs(case: tuple) -> tuple[np.ndarray, np.ndarray]:
    """int32 [G, M] symbols and int32 [G, M] weights of one
    HISTOGRAM_EDGE_CASES case."""
    g, m, n_bins, content = case
    rng = np.random.default_rng(HISTOGRAM_EDGE_CASES.index(case) + 13000)
    if content == "past_2_24":
        symbols = np.full((g, m), n_bins // 2, np.int64)
        weights = rng.integers(990, 1010, (g, m))
        symbols[:, ::7] = rng.integers(0, n_bins, symbols[:, ::7].shape)
    elif content == "in_range":
        symbols = rng.integers(0, n_bins, (g, m))
        weights = rng.choice([0, 0, 0, 1, 1, 1, 2, 7, 1000, -1, -3], (g, m))
    else:
        symbols = rng.integers(-3, n_bins + 3, (g, m))
        symbols[:, 0], symbols[:, -1] = -1, n_bins
        weights = rng.integers(-2, 4, (g, m))
    return symbols.astype(np.int32), weights.astype(np.int32)


# Edge cases of the emission pack (csrc/emission_pack.cu), shared the same
# way. EMISSION_PACK_TILE and EMISSION_PACK_TILE_WORDS are TILE and
# TILE_WORDS there: the blocks of a CTA, and the shared word window past
# which a tile takes the over-full arm. case -> (content, N, images,
# n_words below the stream's need):
# - "photo": ~8 live slots, ~55 bits a block, as a photograph's scan;
# - "dense": ~30 live slots a block;
# - "worst": every slot live with 30 bits (2040-bit blocks), every tile
#   over-full; "mixed": a first tile of worst-case blocks, photo after it;
# - "masked": photo with every third block and the whole second tile cut
#   to length 0, as mask_emissions cuts the blocks that `valid` drops;
# - images > 1: the blocks split into images, each image's stream at a
#   word-aligned base (the fused batch's boff);
# - short: a word buffer of half the stream's words, so pieces are dropped.
EMISSION_PACK_TILE = 32
EMISSION_PACK_TILE_WORDS = 1024
EMISSION_PACK_EDGE_CASES = tuple(
    ("photo", n, 1, False) for n in (1, EMISSION_PACK_TILE - 1, EMISSION_PACK_TILE,
                                     EMISSION_PACK_TILE + 1, 389)
) + (
    ("dense", 389, 1, False), ("worst", 130, 1, False), ("mixed", 200, 1, False),
    ("masked", 389, 1, False), ("photo", 389, 2, False), ("photo", 390, 3, False),
    ("dense", 300, 3, False), ("photo", 389, 1, True), ("mixed", 200, 2, True),
)


def emission_pack_edge_inputs(case: tuple) -> tuple[np.ndarray, ...]:
    """One EMISSION_PACK_EDGE_CASES case as block_emissions lays it out:
    int32 values, lens, offs [N, 68] (slot 0 the DC, 1-63 the ACs, 64-66
    ZRLs, 67 the EOB; offs are block-relative, in stream order DC, then the
    ACs with each ZRL before its AC, then the EOB), int32 block_bits [N],
    n_words, and int64 boff [N] (None for one image: the exclusive scan of
    block_bits)."""
    content, n, images, short = case
    rng = np.random.default_rng(EMISSION_PACK_EDGE_CASES.index(case) + 11000)
    live = np.zeros((n, 68), bool)
    lens = np.zeros((n, 68), np.int64)
    top = 27 if content == "dense" else 12  # a photograph's codes are short
    live[:, 0] = True
    lens[:, 0] = rng.integers(2, top + 1, n)
    if content in ("worst", "mixed"):
        worst = np.arange(n) < (n if content == "worst" else EMISSION_PACK_TILE)
        live[worst] = True
        lens[worst] = 30
    else:
        worst = np.zeros(n, bool)
    p_ac = 0.45 if content == "dense" else 0.09
    ac = (rng.random((n, 63)) < p_ac * np.linspace(1.6, 0.4, 63)) & ~worst[:, None]
    live[:, 1:64] |= ac
    lens[:, 1:64] = np.where(ac, rng.integers(2, top, (n, 63)), lens[:, 1:64])
    zrl = (rng.random((n, 3)) < 0.1) & ac[:, 40:43] & ~worst[:, None]
    live[:, 64:67] |= zrl
    lens[:, 64:67] = np.where(zrl, rng.integers(10, 12, (n, 3)), lens[:, 64:67])
    eob = ~live[:, 63] & ~worst
    live[:, 67] |= eob
    lens[:, 67] = np.where(eob, rng.integers(2, 5, n), lens[:, 67])
    if content == "masked":
        cut = (np.arange(n) % 3 == 1) | (np.arange(n) // EMISSION_PACK_TILE == 1)
        live[cut] = False
        lens[cut] = 0
    lens = np.where(live, lens, 0)
    # stream order: DC, AC 1..63 with ZRL slot 64 + k before AC 41 + k, EOB
    order = np.array([0, *range(1, 41), 64, 41, 65, 42, 66, *range(43, 64), 67])
    offs = np.zeros((n, 68), np.int64)
    offs[:, order] = np.cumsum(lens[:, order], axis=1) - lens[:, order]
    values = rng.integers(0, 1 << 30, (n, 68)) & ((1 << lens) - 1)
    bits = lens.sum(axis=1)
    boff = None
    if images > 1:
        seg = np.arange(n) * images // n
        starts = np.searchsorted(seg, np.arange(images))
        in_seg = np.concatenate([np.cumsum(b) - b for b in np.split(bits, starts[1:])])
        seg_words = [(int(b.sum()) + 31) // 32 for b in np.split(bits, starts[1:])]
        word_off = np.concatenate([[0], np.cumsum(seg_words)[:-1]])
        boff = (word_off[seg] * 32 + in_seg).astype(np.int64)
        need = int(word_off[-1]) + seg_words[-1]
    else:
        need = (int(bits.sum()) + 31) // 32
    n_words = need // 2 if short else need + 2
    return (values.astype(np.int32), lens.astype(np.int32), offs.astype(np.int32),
            bits.astype(np.int32), n_words, boff)


def emission_pack_tile_arms(block_bits: np.ndarray, boff: np.ndarray | None) -> list[str]:
    """Which arm each EMISSION_PACK_TILE tile of the kernel takes: "empty"
    (no bit), "shared" (its words fit the window) or "over-full"."""
    bits = block_bits.astype(np.int64)
    boff = np.cumsum(bits) - bits if boff is None else boff
    end = int(boff[-1] + bits[-1])
    arms = []
    for t in range(0, len(bits), EMISSION_PACK_TILE):
        lo = int(boff[t])
        hi = int(boff[t + EMISSION_PACK_TILE]) if t + EMISSION_PACK_TILE < len(bits) else end
        count = ((hi - 1) >> 5) - (lo >> 5) + 1 if hi > lo else 0
        arms.append("empty" if not count else "shared" if count <= EMISSION_PACK_TILE_WORDS
                    else "over-full")
    return arms


def block_hist_edge_segments(case: tuple) -> list[np.ndarray]:
    """The int16 [n, 64] blocks of each segment of a BLOCK_HIST_EDGE_CASES
    case (DC already DPCM'd)."""
    content, sizes, _ = case
    rng = np.random.default_rng(BLOCK_HIST_EDGE_CASES.index(case) + 9000)
    pool = (random_blocks(int(rng.integers(1 << 30))) if content == "random"
            else scan_pack_edge_blocks(content)[0])
    blocks = pool[rng.integers(0, len(pool), sum(sizes))]
    return [np.ascontiguousarray(part) for part in np.split(blocks, [sizes[0]])[: len(sizes)]]


def scan_pack_edge_blocks(case: str) -> tuple[np.ndarray, int, int]:
    """One SCAN_PACK_EDGE_CASES case: (blocks int16 [N, 64], stride, lpm)."""
    rng = np.random.default_rng(SCAN_PACK_EDGE_CASES.index(case) + 7000)
    tile = SCAN_PACK_TILE
    n = {"n1": 1, "tile-1": tile - 1, "tile": tile, "tile+1": tile + 1}.get(case, 3 * tile + 5)
    if case in ("n1", "tile-1", "tile", "tile+1", "tiles3+5"):
        if case == "n1":
            return random_blocks(int(rng.integers(1 << 30)), 20)[5:6], 3, 1
        return random_blocks(int(rng.integers(1 << 30)), n), 6, 4
    blocks = np.zeros((n, 64), np.int64)
    blocks[:, 0] = rng.integers(-60, 61, n)
    if case == "no_ac":
        blocks[::7, 0] = 0
    elif case == "all_ac":
        blocks[:, 1:] = rng.integers(1, 6, (n, 63)) * rng.choice([-1, 1], (n, 63))
    elif case == "zero_runs":
        # runs of 15, 16, 17, 31, 32, 47 and 48 zeros (0-3 ZRLs) before a
        # nonzero, starting at each lane boundary and off it
        runs = (15, 16, 17, 31, 32, 47, 48)
        for i in range(n):
            run, start = runs[i % len(runs)], 1 + (i // len(runs)) % 9
            pos = start + run
            if pos <= 63:
                blocks[i, 1:start] = rng.integers(1, 4, start - 1)
                blocks[i, pos] = rng.integers(1, 30) * rng.choice([-1, 1])
                if pos + 17 <= 63 and i % 2:
                    blocks[i, pos + 17] = -3
            else:
                blocks[i, 63] = 1
    elif case == "only_63":
        blocks[:, 63] = rng.integers(1, 200, n) * rng.choice([-1, 1], n)
    elif case == "extreme":
        # DC differences of category 11, AC values of category 10
        blocks[:, 0] = rng.integers(1024, 2048, n) * rng.choice([-1, 1], n)
        sparse = rng.random((n, 63)) < 0.3
        blocks[:, 1:] = np.where(sparse, rng.integers(512, 1024, (n, 63)) * rng.choice([-1, 1], (n, 63)), 0)
    elif case == "overfull":
        # near-worst-case blocks: every AC nonzero, mostly of category 9 and
        # 10, so the first tile passes the shared word buffer
        blocks[:, 0] = rng.integers(1024, 2048, n) * rng.choice([-1, 1], n)
        cats = np.where(rng.random((n, 63)) < 0.8, rng.integers(9, 11, (n, 63)), rng.integers(1, 9, (n, 63)))
        mags = (1 << (cats - 1)) + rng.integers(0, 1 << 30, (n, 63)) % (1 << (cats - 1))
        blocks[:, 1:] = mags * rng.choice([-1, 1], (n, 63))
    else:
        raise KeyError(case)
    return blocks.astype(np.int16), 6, 4


def scan_pack_edge_mask(name: str, n: int) -> np.ndarray:
    """int32 [n] `valid` mask of SCAN_PACK_EDGE_MASKS."""
    idx = np.arange(n)
    return {"all": idx >= 0, "none": idx < 0, "alternating": idx % 2 == 0,
            "single": idx == n // 2}[name].astype(np.int32)


def _stuff_row(rng, n_bytes: int, pad: int, ff_at=(), ff_share: float = 0.1) -> np.ndarray:
    """A stream of n_bytes bytes whose last `pad` bits are zero (bits past
    the stream), a share of them 0xFF, and 0xFF at `ff_at`."""
    raw = rng.integers(0, 256, n_bytes).astype(np.uint8)
    raw[rng.random(n_bytes) < ff_share] = 0xFF
    raw[[i for i in ff_at if i < n_bytes]] = 0xFF
    if n_bytes and pad:
        raw[-1] &= (0xFF << pad) & 0xFF
    return raw


def stuff_edge_rows(case: str) -> tuple[np.ndarray, np.ndarray]:
    """One STUFF_EDGE_CASES case: (words int32 [B, n_words], each row a
    stream in memory byte order, zero past its bits; total_bits int64 [B]).
    Rows hold 3 x their stream + 64 words (room for the stuffed copy)
    unless the case is a short tail: 2 words past the stream, as a scan
    pack's worst-case buffer leaves at least."""
    rng = np.random.default_rng(STUFF_EDGE_CASES.index(case) + 9100)
    edges = [e + d for e in (16, 32, STUFF_CHUNK, 2 * STUFF_CHUNK) for d in (-1, 0, 1)]
    rows = {  # (n_bytes, pad, the stream's bytes)
        "all_ff": [(3 * STUFF_CHUNK - 5, 0, np.full(3 * STUFF_CHUNK - 5, 0xFF, np.uint8))],
        "pad_makes_ff": [(301, 4, np.r_[_stuff_row(rng, 300, 0, ff_share=0), [0xF0]])],
        "ff_offsets": [(2 * STUFF_CHUNK + 37, 3, _stuff_row(
            rng, 2 * STUFF_CHUNK + 37, 3, ff_at=[4 * k + j for k in (0, 5, 900) for j in range(4)]
            + edges, ff_share=0.02))],
        "empty": [(0, 0, np.zeros(0, np.uint8))],
        "slab_rows": [(0, 0, np.zeros(0, np.uint8)), (5000, 3, _stuff_row(rng, 5000, 3)),
                      (100, 0, _stuff_row(rng, 100, 0, ff_share=0.5)),
                      (STUFF_CHUNK, 7, _stuff_row(rng, STUFF_CHUNK, 7))],
        "short_tail": [(700, 2, _stuff_row(rng, 700, 2))],
        "short_slab_row": [(60, 1, _stuff_row(rng, 60, 1)), (9000, 0, _stuff_row(rng, 9000, 0))],
    }.get(case)
    if rows is None:  # "pad<k>": a stream of 1,001 bytes whose last k bits are padding
        pad = int(case[3:])
        rows = [(1001, pad, _stuff_row(rng, 1001, pad))]
    need = max((n + 3) // 4 for n, _, _ in rows)
    n_words = need + 2 if case.startswith("short") else 3 * need + 64
    n_words += n_words % 2
    words = np.zeros((len(rows), n_words), np.int32)
    for r, (n, _, raw) in enumerate(rows):
        words[r].view(np.uint8)[:n] = raw
    return words, np.array([8 * n - pad for n, pad, _ in rows], np.int64)


def scan_pack_tables(blocks: np.ndarray, stride: int, lpm: int) -> tuple[np.ndarray, np.ndarray]:
    """int32 codes and lens [4, 256] (luma DC, luma AC, chroma DC, chroma
    AC) built from the blocks' own histograms as the pipeline builds them
    (package-merge code lengths, canonical codes; a class with no block
    takes all blocks' histograms); imports the port."""
    import torch

    from dmmt_jpeg_encoder_tpu_torch.encoder import HuffmanTables
    from dmmt_jpeg_encoder_tpu_torch.entropy.categorize import symbol_histograms

    chroma = np.arange(len(blocks)) % stride >= lpm
    parts = [blocks[~chroma], blocks[chroma]]
    parts = [p if len(p) else blocks for p in parts]  # N = 1: one class takes the other's
    hists = [h.numpy() for part in parts
             for h in symbol_histograms(torch.from_numpy(np.ascontiguousarray(part)))]
    flat = HuffmanTables.from_host_histograms(*hists).flat()
    return (np.array([c for c, _ in flat], np.int32), np.array([ln for _, ln in flat], np.int32))


def phase1_edge_pixels(h: int, w: int, maxval: int) -> np.ndarray:
    """RGB [h, w, 3] samples over the whole range 0..maxval (uint8, or
    uint16 above 255)."""
    rng = np.random.default_rng(h * 100003 + w * 7 + maxval)
    return rng.integers(0, maxval + 1, (h, w, 3)).astype(np.uint8 if maxval <= 255 else np.uint16)


def sha256(data: bytes | np.ndarray) -> str:
    if isinstance(data, np.ndarray):
        data = np.ascontiguousarray(data).tobytes()
    return hashlib.sha256(data).hexdigest()


def load_goldens() -> dict:
    return json.loads(GOLDENS_PATH.read_text())["fixtures"]


def load_batch_goldens() -> dict:
    return json.loads(GOLDENS_PATH.read_text())["batches"]


def load_route_goldens() -> tuple[dict, dict]:
    """(route -> fixture -> entry, route -> batch -> [entry per frame])."""
    data = json.loads(GOLDENS_PATH.read_text())
    return data["routes"], data["route_batches"]


def _jax_encode(pixels: np.ndarray, f: dict, route: str | None = None) -> bytes:
    """The JAX package's encode_array under `route` (imports JAX)."""
    import dmmt_jpeg_encoder_tpu as dj

    config = dj.EncoderConfig(
        chroma_subsampling=dj.ChromaSubsamplingPreset(f["preset"]), quality=f["quality"],
        dct_variant=dj.DCTVariant(ROUTES[route][1] if route else "arai"),
    )
    with route_env(route):
        return dj.encode_array(pixels, f["maxval"], config)


def _entry(pixels: np.ndarray, jpeg: bytes) -> dict:
    return {"pixels_sha256": sha256(pixels), "jpeg_sha256": sha256(jpeg), "jpeg_len": len(jpeg)}


def golden_entry(name: str, route: str | None = None) -> dict:
    return _entry(fixture_pixels(name), _jax_encode(fixture_pixels(name), FIXTURES[name], route))


def batch_golden_entry(name: str, route: str | None = None) -> list[dict]:
    f = BATCH_FIXTURES[name]
    return [_entry(px, _jax_encode(px, f, route)) for px in batch_frames(name)]


def write_goldens() -> None:
    out = {
        "source": "dmmt_jpeg_encoder_tpu.encode_array on the JAX CPU backend",
        "fixtures": {name: golden_entry(name) for name in FIXTURES},
        "batches": {name: batch_golden_entry(name) for name in BATCH_FIXTURES},
        "routes": {route: {name: golden_entry(name, route) for name in FIXTURES}
                   for route in ROUTES},
        "route_batches": {route: {name: batch_golden_entry(name, route) for name in names}
                          for route, names in ROUTE_BATCHES.items()},
    }
    GOLDENS_PATH.write_text(json.dumps(out, indent=1) + "\n")


if __name__ == "__main__":
    import sys

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    write_goldens()
    print(GOLDENS_PATH.read_text())
