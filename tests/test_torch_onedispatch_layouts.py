"""PyTorch port, the one-dispatch entry points' input layouts and the
multi-image start: channel-planar samples ([3, H, W], and [B, 3, H, W] for
the slab and start_one_dispatch_multi) against interleaved ones, B
single-image enqueues against B standalone starts, and every JPEG against
the JAX package's encode_array bytes on the CPU; one case against the JAX
start_one_dispatch_multi itself (Pallas interpret mode). Mirrors
test_onedispatch.py, test_slab.py and test_fused_phase1.py. The tolerance
is zero: bytes and tables must be identical."""

import os

import numpy as np
import pytest
import torch

import dmmt_jpeg_encoder_tpu as dj
from dmmt_jpeg_encoder_tpu import onedispatch as jod
from dmmt_jpeg_encoder_tpu_torch import encoder as tenc
from dmmt_jpeg_encoder_tpu_torch import onedispatch as tod
from dmmt_jpeg_encoder_tpu_torch.config import config_from_jax
from dmmt_jpeg_encoder_tpu_torch.ops.geometry import padded_size
from dmmt_jpeg_encoder_tpu_torch.pipeline import image_layout
from dmmt_jpeg_encoder_tpu_torch.tables import quantization_table_pair

_JAX_CACHE: dict = {}


def _images(n, shape, seed):
    """n distinct seeded integer frames: a ramp plus noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0 : shape[0], 0 : shape[1]]
    frames = []
    for i in range(n):
        base = 30 + ((xx + 7 * i) * 170) // (shape[1] + 7 * n) + (yy * 40) // shape[0]
        frames.append(np.clip(base[..., None] + rng.integers(-20, 21, (*shape, 3)), 0, 255))
    return np.stack(frames).astype(np.uint8)


# every test draws its images from these, so that each JAX encode_array
# (one compile per geometry, preset and route) serves several tests
IMAGES = {(48, 64): _images(3, (48, 64), 1), (37, 53): _images(3, (37, 53), 2),
          (3, 11): _images(2, (3, 11), 4)}


def _planar(stack):
    return np.ascontiguousarray(np.moveaxis(stack, -1, -3))


def _config(preset):
    jax_cfg = dj.EncoderConfig(chroma_subsampling=dj.ChromaSubsamplingPreset(preset))
    cfg = config_from_jax(jax_cfg)
    return jax_cfg, cfg, *quantization_table_pair(cfg.quantization_preset, cfg.quality)


def _want(px, jax_cfg):
    """The JAX package's encode_array of an interleaved image under the
    current DMMT_P1 (cached by content)."""
    key = (px.tobytes(), px.shape, jax_cfg.chroma_subsampling, os.environ.get("DMMT_P1"))
    if key not in _JAX_CACHE:
        _JAX_CACHE[key] = dj.encode_array(px, 255, jax_cfg)
    return _JAX_CACHE[key]


def _finish(states, cfg, lq, cq, shape):
    """JPEG bytes of each state, finished in the JAX package's call form."""
    for state in states:
        tod.prefetch_one_dispatch(state, cfg)
    return [tenc._jpeg(shape, cfg, lq, cq, *tod.finish_one_dispatch(state, cfg)) for state in states]


@pytest.mark.parametrize("shape,preset,route", [
    ((48, 64), "P420", None), ((48, 64), "P444", None), ((37, 53), "P420", None),
    ((37, 53), "P444", None), ((48, 64), "P420", "fused1"), ((48, 64), "P422", "fused1"),
])
def test_start_one_dispatch_planar_matches_interleaved(monkeypatch, shape, preset, route):
    """test_onedispatch.py:120 and test_fused_phase1.py:254: [3, H, W]
    gives the bytes of [H, W, 3], as a host array and as a tensor."""
    if route:
        monkeypatch.setenv("DMMT_P1", route)
    jax_cfg, cfg, lq, cq = _config(preset)
    px = IMAGES[shape][0]
    planar = _planar(px)
    inputs = [px, planar, torch.from_numpy(planar)]
    got = [_finish([tod.start_one_dispatch(x, 255, cfg, lq, cq, device="cpu")], cfg, lq, cq, shape)[0]
           for x in inputs]
    assert got == [_want(px, jax_cfg)] * len(inputs)


@pytest.mark.parametrize("onepack", ["0", "1"])
@pytest.mark.parametrize("shape,preset", [((37, 53), "P420"), ((48, 64), "P444")])
def test_slab_planar_stack_matches_jax(monkeypatch, shape, preset, onepack):
    """test_slab.py:96: a planar host stack (pre-padded here in its own
    layout), a padded planar tensor and the interleaved stack give each
    image's own bytes."""
    monkeypatch.setenv("DMMT_SLAB_ONEPACK", onepack)
    jax_cfg, cfg, lq, cq = _config(preset)
    stack = IMAGES[shape]
    ph, pw = padded_size(*shape, cfg.chroma_subsampling)
    padded = torch.zeros((3, 3, ph, pw), dtype=torch.uint8)
    padded[:, :, : shape[0], : shape[1]] = torch.from_numpy(_planar(stack))
    want = [_want(px, jax_cfg) for px in stack]
    for x in (stack, _planar(stack), padded):
        assert _finish(tod.start_one_dispatch_slab(x, 255, cfg, lq, cq, device="cpu"),
                       cfg, lq, cq, shape) == want


def test_slab_rejects_unpadded_planar_tensor():
    _, cfg, lq, cq = _config("P420")
    with pytest.raises(ValueError, match="MCU-padded: 37x53 -> 48x64"):
        tod.start_one_dispatch_slab(torch.zeros((2, 3, 37, 53), dtype=torch.uint8), 255, cfg,
                                    lq, cq, device="cpu")


@pytest.mark.parametrize("b,shape,preset,route", [
    (2, (48, 64), "P420", None), (3, (37, 53), "P444", None), (3, (48, 64), "P444", "fused1"),
])
def test_start_one_dispatch_multi_matches_single_starts(monkeypatch, b, shape, preset, route):
    """test_onedispatch.py:142 and test_fused_phase1.py:224: each state of
    a group finishes to a standalone start's scan and tables, for
    interleaved and planar host stacks and a planar tensor."""
    if route:
        monkeypatch.setenv("DMMT_P1", route)
    jax_cfg, cfg, lq, cq = _config(preset)
    stack = IMAGES[shape][:b]
    singles = [tod.finish_one_dispatch(tod.start_one_dispatch(px, 255, cfg, lq, cq, device="cpu"))
               for px in stack]
    for x in (stack, _planar(stack), torch.from_numpy(_planar(stack))):
        states = tod.start_one_dispatch_multi(x, 255, cfg, lq, cq, device="cpu")
        assert len(states) == b
        assert [tod.finish_one_dispatch(s, cfg) for s in states] == singles
    jpegs = [tenc._jpeg(shape, cfg, lq, cq, *s) for s in singles]
    assert jpegs == [_want(px, jax_cfg) for px in stack]


def test_start_one_dispatch_multi_matches_jax_multi(monkeypatch):
    """The JAX start_one_dispatch_multi (Pallas interpret mode) on a planar
    stack of two 8x8 images: the same scans and tables per image."""
    monkeypatch.setenv("DMMT_PALLAS_INTERPRET", "1")
    jax_cfg, cfg, lq, cq = _config("P444")
    planar = _planar(_images(2, (8, 8), 9))
    ref = [jod.finish_one_dispatch(s, jax_cfg)
           for s in jod.start_one_dispatch_multi(planar, 255, jax_cfg, lq, cq)]
    got = [tod.finish_one_dispatch(s, cfg)
           for s in tod.start_one_dispatch_multi(planar, 255, cfg, lq, cq, device="cpu")]

    def lists(tables):
        return [[(c.symbol, c.length) for c in t] for t in
                (tables.luma_dc, tables.luma_ac, tables.chroma_dc, tables.chroma_ac)]

    assert [scan for scan, _ in got] == [scan for scan, _ in ref]
    assert [lists(t) for _, t in got] == [lists(t) for _, t in ref]


def test_finish_and_prefetch_take_the_jax_call_form():
    _, cfg, lq, cq = _config("P420")
    px = _images(1, (16, 24), 3)[0]
    plain = tod.finish_one_dispatch(tod.start_one_dispatch(px, 255, cfg, lq, cq, device="cpu"))
    state = tod.start_one_dispatch(px, 255, cfg, lq, cq, device="cpu")
    tod.prefetch_one_dispatch(state, cfg)
    tod.prefetch_one_dispatch(state, config=cfg)
    assert tod.finish_one_dispatch(state, config=cfg) == plain


@pytest.mark.parametrize("shape,want", [((3, 11, 3), (False, 3, 11)), ((3, 11, 5), (True, 11, 5)),
                                        ((11, 5, 3), (False, 11, 5)), ((3, 3, 3), (False, 3, 3))])
def test_image_layout_detection(shape, want):
    assert image_layout(shape) == want


def test_three_by_w_by_three_is_interleaved():
    """[3, W, 3] is a 3-row interleaved image, as in the JAX package: a
    single start, the slab and the group of a [B, 3, W, 3] stack give the
    JAX package's bytes of each 3 x W image."""
    jax_cfg, cfg, lq, cq = _config("P420")
    stack = IMAGES[(3, 11)]
    want = [_want(px, jax_cfg) for px in stack]
    single = [_finish([tod.start_one_dispatch(px, 255, cfg, lq, cq, device="cpu")], cfg, lq, cq,
                      (3, 11))[0] for px in stack]
    assert single == want
    for start in (tod.start_one_dispatch_slab, tod.start_one_dispatch_multi):
        assert _finish(start(stack, 255, cfg, lq, cq, device="cpu"), cfg, lq, cq, (3, 11)) == want
