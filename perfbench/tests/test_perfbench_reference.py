"""The plain reference encoder against the JAX-made goldens of the port's
test fixtures (tests/torch_port_goldens.json), and its control."""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest

from perfbench import reference
from perfbench.frames import frame_pixels

GOLDENS = Path(__file__).resolve().parents[2] / "tests" / "torch_port_goldens.json"
# the small fixtures of tests/torch_port_fixtures.py: geometry, maxval,
# preset, quality, seed
FIXTURES = {
    "4k_p420": (2160, 3840, 255, "P420", None, 0),
    "333x1001_p422": (333, 1001, 255, "P422", 75, 1),
    "7x17_p444": (7, 17, 255, "P444", None, 2),
    "123x205_maxval4095_p420": (123, 205, 4095, "P420", None, 3),
}
# batches: geometry, maxval, preset, quality, the first frame's seed (frame
# i has seed + i), and the frames held against their goldens
BATCHES = {
    "batch_odd_p422": ((45, 71, 255, "P422", 90, 300), range(3)),
    "batch_1080p_p420": ((1080, 1920, 255, "P420", None, 100), range(1)),
}


def sha(data) -> str:
    if isinstance(data, np.ndarray):
        data = np.ascontiguousarray(data).tobytes()
    return hashlib.sha256(data).hexdigest()


def config(preset: str, quality) -> dict:
    return {"chroma_subsampling": preset, "quantization_preset": "SPECIFICATION",
            "quality": quality, "bits_per_channel": 8}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_reference_equals_golden(name):
    h, w, maxval, preset, quality, seed = FIXTURES[name]
    golden = json.loads(GOLDENS.read_text())["fixtures"][name]
    px = frame_pixels(h, w, maxval, seed)
    assert sha(px) == golden["pixels_sha256"]
    jpeg = reference.encode(px, maxval, config(preset, quality))
    assert (sha(jpeg), len(jpeg)) == (golden["jpeg_sha256"], golden["jpeg_len"])


@pytest.mark.parametrize("batch, i", [(b, i) for b, (_, frames) in BATCHES.items() for i in frames])
def test_reference_equals_batch_golden(batch, i):
    (h, w, maxval, preset, quality, seed), _ = BATCHES[batch]
    golden = json.loads(GOLDENS.read_text())["batches"][batch][i]
    px = frame_pixels(h, w, maxval, seed + i)
    assert sha(px) == golden["pixels_sha256"]
    assert sha(reference.encode(px, maxval, config(preset, quality))) == golden["jpeg_sha256"]


@pytest.mark.parametrize("name", sorted(set(FIXTURES) - {"4k_p420"}))
def test_bfloat16_control_differs(name):
    """The control (the reference in bfloat16) changes the bytes."""
    h, w, maxval, preset, quality, seed = FIXTURES[name]
    px = frame_pixels(h, w, maxval, seed)
    cfg = config(preset, quality)
    assert reference.encode(px, maxval, cfg, precision="bfloat16") != reference.encode(px, maxval, cfg)


@pytest.mark.card
def test_reference_on_the_card_equals_4k_golden(card):
    """The reference as the benchmark runs it, on the card."""
    h, w, maxval, preset, quality, seed = FIXTURES["4k_p420"]
    golden = json.loads(GOLDENS.read_text())["fixtures"]["4k_p420"]
    jpeg = reference.encode(frame_pixels(h, w, maxval, seed), maxval, config(preset, quality),
                            device=card)
    assert (sha(jpeg), len(jpeg)) == (golden["jpeg_sha256"], golden["jpeg_len"])
