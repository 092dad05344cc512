"""Fixture images shared by the PyTorch-port tests and chip_smoke.py.

The pixels are built with integer-only numpy (default_rng(seed).integers
and integer gradients, no floating point), so every machine builds the
same bytes. `torch_port_goldens.json` holds, per fixture, the sha256 of
the pixels and of the JAX package's `encode_array` bytes on the CPU: the
machine with the GPU has no JAX, so the port's output there is held
against these digests. Batch fixtures (`BATCH_FIXTURES`, under the key
"batches") hold the same per frame; frame i of a batch is built from the
batch's seed + i, so every frame differs.

Regenerate the goldens (needs the JAX package) with

    JAX_PLATFORMS=cpu python tests/torch_port_fixtures.py
"""

from __future__ import annotations

import hashlib
import json
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


def sha256(data: bytes | np.ndarray) -> str:
    if isinstance(data, np.ndarray):
        data = np.ascontiguousarray(data).tobytes()
    return hashlib.sha256(data).hexdigest()


def load_goldens() -> dict:
    return json.loads(GOLDENS_PATH.read_text())["fixtures"]


def load_batch_goldens() -> dict:
    return json.loads(GOLDENS_PATH.read_text())["batches"]


def _jax_encode(pixels: np.ndarray, f: dict) -> bytes:
    """The JAX package's encode_array (imports JAX)."""
    import dmmt_jpeg_encoder_tpu as dj

    config = dj.EncoderConfig(
        chroma_subsampling=dj.ChromaSubsamplingPreset(f["preset"]), quality=f["quality"]
    )
    return dj.encode_array(pixels, f["maxval"], config)


def _entry(pixels: np.ndarray, jpeg: bytes) -> dict:
    return {"pixels_sha256": sha256(pixels), "jpeg_sha256": sha256(jpeg), "jpeg_len": len(jpeg)}


def golden_entry(name: str) -> dict:
    return _entry(fixture_pixels(name), _jax_encode(fixture_pixels(name), FIXTURES[name]))


def batch_golden_entry(name: str) -> list[dict]:
    f = BATCH_FIXTURES[name]
    return [_entry(px, _jax_encode(px, f)) for px in batch_frames(name)]


def write_goldens() -> None:
    out = {
        "source": "dmmt_jpeg_encoder_tpu.encode_array on the JAX CPU backend",
        "fixtures": {name: golden_entry(name) for name in FIXTURES},
        "batches": {name: batch_golden_entry(name) for name in BATCH_FIXTURES},
    }
    GOLDENS_PATH.write_text(json.dumps(out, indent=1) + "\n")


if __name__ == "__main__":
    import sys

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    write_goldens()
    print(GOLDENS_PATH.read_text())
