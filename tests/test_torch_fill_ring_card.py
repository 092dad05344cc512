"""PyTorch port: a host frame's upload through the card's pinned ring
(programs.copy_in, programs._Ring). The ring exists only on a card, so
every test here skips without one; on a card:
`python -m pytest --noconftest tests/test_torch_fill_ring_card.py`. It
imports no JAX and holds the card's JPEGs against the JAX goldens of
tests/torch_port_goldens.json. The tests that need the ring for small
frames lower programs.RING_MIN_BYTES to 0:

- a 4K frame takes the ring and a 1080p frame the pageable copy, as
  RING_MIN_BYTES says;
- encode_array through the ring: the 4K P420 fixture, the first 1080p
  frame, the 123x205 P420 fixture at maxval 4095, the 4K fixture from a
  non-contiguous view and sharded over two shards on one card, and a
  planar [3, H, W] 4K frame through start_one_dispatch;
- the caller's array overwritten as soon as start_one_dispatch returns:
  the JPEG is unchanged (every byte was read before the fill returned);
- 50 calls across 4K and 1080p frames after warm-up: one ring per card,
  the same pinned memory;
- two threads filling the inputs of two programs at once: both right."""

import hashlib
import sys
import threading

import numpy as np
import pytest
import torch

import dmmt_jpeg_encoder_tpu_torch as dt
from dmmt_jpeg_encoder_tpu_torch import encoder as tenc
from dmmt_jpeg_encoder_tpu_torch import onedispatch as tod
from dmmt_jpeg_encoder_tpu_torch import programs
from dmmt_jpeg_encoder_tpu_torch.tables import quantization_table_pair
from torch_port_fixtures import (
    BATCH_FIXTURES,
    FIXTURES,
    batch_frames,
    fixture_pixels,
    load_batch_goldens,
    load_goldens,
)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the pinned ring carries host frames to a card only")
    return torch.device("cuda", 0)


@pytest.fixture
def every_frame(card, monkeypatch):
    """The card, with every host frame sent through the ring."""
    monkeypatch.setattr(programs, "RING_MIN_BYTES", 0)
    return card


def _config(f: dict, **kw) -> dt.EncoderConfig:
    return dt.EncoderConfig(chroma_subsampling=dt.ChromaSubsamplingPreset(f["preset"]),
                            quality=f["quality"], **kw)


def _sha(jpeg: bytes) -> str:
    return hashlib.sha256(jpeg).hexdigest()


def _cases():
    """(name, pixels, maxval, config, device, golden sha256)."""
    goldens = load_goldens()
    f4k = FIXTURES["4k_p420"]
    px4k = fixture_pixels("4k_p420")
    wide = np.zeros((f4k["height"] + 3, f4k["width"] + 5, 3), np.uint8)
    wide[2:-1, 1:-4] = px4k
    f1080 = BATCH_FIXTURES["batch_1080p_p420"]
    deep = FIXTURES["123x205_maxval4095_p420"]
    return [
        ("4k", px4k, 255, _config(f4k), "cuda", goldens["4k_p420"]["jpeg_sha256"]),
        ("1080p", batch_frames("batch_1080p_p420")[0], 255, _config(f1080), "cuda",
         load_batch_goldens()["batch_1080p_p420"][0]["jpeg_sha256"]),
        ("maxval4095", fixture_pixels("123x205_maxval4095_p420"), deep["maxval"], _config(deep),
         "cuda", goldens["123x205_maxval4095_p420"]["jpeg_sha256"]),
        ("non-contiguous", wide[2:-1, 1:-4], 255, _config(f4k), "cuda",
         goldens["4k_p420"]["jpeg_sha256"]),
        ("sharded", px4k, 255, _config(f4k, num_shards=2), ["cuda:0"] * 2,
         goldens["4k_p420"]["jpeg_sha256"]),
    ]


def test_only_large_frames_take_the_ring(card, monkeypatch):
    uploads = []
    upload = programs._Ring.upload

    def counted(self, dst, pixels, maxval):
        uploads.append(pixels.shape)
        return upload(self, dst, pixels, maxval)

    monkeypatch.setattr(programs._Ring, "upload", counted)
    goldens = load_goldens()
    px1080 = batch_frames("batch_1080p_p420")[0]
    assert px1080.nbytes <= programs.RING_MIN_BYTES < fixture_pixels("4k_p420").nbytes
    cfg1080 = _config(BATCH_FIXTURES["batch_1080p_p420"])
    jpeg = dt.encode_array(px1080, 255, cfg1080, device="cuda")
    assert _sha(jpeg) == load_batch_goldens()["batch_1080p_p420"][0]["jpeg_sha256"]
    assert uploads == []
    jpeg = dt.encode_array(fixture_pixels("4k_p420"), 255, _config(FIXTURES["4k_p420"]),
                           device="cuda")
    assert _sha(jpeg) == goldens["4k_p420"]["jpeg_sha256"] and uploads == [(2160, 3840, 3)]


def test_encodes_through_the_ring_equal_the_goldens(every_frame):
    card = every_frame
    before = programs.RING_ALLOCATIONS[card.index]
    for name, px, maxval, cfg, device, want in _cases():
        assert _sha(dt.encode_array(px, maxval, cfg, device=device)) == want, name
    assert card.index in programs._RINGS
    assert programs.RING_ALLOCATIONS[card.index] == max(before, 1)

    f = FIXTURES["4k_p420"]
    cfg = _config(f)
    lq, cq = quantization_table_pair(cfg.quantization_preset, cfg.quality)
    planar = np.ascontiguousarray(fixture_pixels("4k_p420").transpose(2, 0, 1))
    state = tod.start_one_dispatch(planar, 255, cfg, lq, cq, device="cuda")
    jpeg = tenc._jpeg((f["height"], f["width"], 3), cfg, lq, cq, *tod.finish_one_dispatch(state))
    assert _sha(jpeg) == load_goldens()["4k_p420"]["jpeg_sha256"]


def test_source_overwritten_after_the_start(every_frame):
    f = FIXTURES["4k_p420"]
    cfg = _config(f)
    lq, cq = quantization_table_pair(cfg.quantization_preset, cfg.quality)
    px = fixture_pixels("4k_p420").copy()
    state = tod.start_one_dispatch(px, 255, cfg, lq, cq, device="cuda")
    px[:] = 255 - px  # before the card has run anything of the replay
    jpeg = tenc._jpeg(px.shape, cfg, lq, cq, *tod.finish_one_dispatch(state))
    assert _sha(jpeg) == load_goldens()["4k_p420"]["jpeg_sha256"]


def test_the_ring_is_allocated_once_per_card(every_frame):
    card = every_frame
    f4k, f1080 = FIXTURES["4k_p420"], BATCH_FIXTURES["batch_1080p_p420"]
    frames = [(fixture_pixels("4k_p420"), _config(f4k)),
              (batch_frames("batch_1080p_p420")[1], _config(f1080))]
    for px, cfg in frames:  # warm-up
        dt.encode_array(px, 255, cfg, device="cuda")
    allocations = dict(programs.RING_ALLOCATIONS)
    pinned = programs._RINGS[card.index].host.data_ptr()
    jpegs = {}
    for i in range(50):
        px, cfg = frames[i % 2]
        jpegs.setdefault(i % 2, set()).add(dt.encode_array(px, 255, cfg, device="cuda"))
    assert dict(programs.RING_ALLOCATIONS) == allocations and allocations[card.index] == 1
    assert programs._RINGS[card.index].host.data_ptr() == pinned
    assert all(len(v) == 1 for v in jpegs.values())


def test_two_threads_fill_at_once(every_frame):
    card = every_frame
    rng = np.random.default_rng(2500)
    shapes = ((2160, 3840, 3), (1080, 1920, 3))
    frames = [[rng.integers(0, 256, s, dtype=np.uint8) for _ in range(3)] for s in shapes]
    inputs = [torch.zeros(s, dtype=torch.uint8, device=card) for s in shapes]
    barrier, errors, rounds = threading.Barrier(2), [], 20

    def fill(t):
        try:
            barrier.wait(timeout=60)
            for r in range(rounds):
                px = frames[t][r % 3]
                programs.copy_in(inputs[t], px, 255)
                torch.cuda.current_stream(card).synchronize()
                if not torch.equal(inputs[t].cpu(), torch.from_numpy(px)):
                    errors.append((t, r))
        except BaseException as exc:  # reported on the main thread
            errors.append(exc)

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=fill, args=(t,)) for t in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
    finally:
        sys.setswitchinterval(saved)
    assert not any(th.is_alive() for th in threads)
    assert errors == []
