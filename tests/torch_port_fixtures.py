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
variant), and under "route_batches" the frames of the batches named in
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
}
# route -> batch fixtures with goldens under it
ROUTE_BATCHES: dict[str, list[str]] = {
    "p1_mxu": ["batch_1080p_p420"],
    "dct_fused": ["batch_1080p_p420"],
}


@contextlib.contextmanager
def route_env(route: str | None):
    """DMMT_P1 as `route` sets it (unset for a DCT-variant route or None),
    restored after the block."""
    saved = os.environ.pop("DMMT_P1", None)
    mode = ROUTES[route][0] if route else None
    if mode:
        os.environ["DMMT_P1"] = mode
    try:
        yield
    finally:
        os.environ.pop("DMMT_P1", None)
        if saved is not None:
            os.environ["DMMT_P1"] = saved


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
