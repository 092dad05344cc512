"""PyTorch port, batch encode: the row-stacked slab (both pack arms), the
pipelined per-image path and the slab gate, against the JAX package's
per-image encode_array on the CPU, byte for byte.

Every batch holds distinct frames: a DPCM chain that does not reset at an
image start, or tables built from a group's summed histograms, would still
pass on identical frames. Guards count the calls that reach phase 1 and
the slab pack, since equal bytes alone cannot show which path ran."""

import numpy as np
import pytest
import torch

import dmmt_jpeg_encoder_tpu as dj
import dmmt_jpeg_encoder_tpu_torch as dt
from dmmt_jpeg_encoder_tpu_torch import encoder as tenc
from dmmt_jpeg_encoder_tpu_torch import onedispatch as tod
from dmmt_jpeg_encoder_tpu_torch.config import config_from_jax
from dmmt_jpeg_encoder_tpu_torch.tables import quantization_table_pair

_JAX_CACHE: dict = {}


def _frames(n, shape, seed, maxval=255):
    """n distinct frames: a ramp shifted per frame plus noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0 : shape[0], 0 : shape[1]]
    out = []
    for i in range(n):
        base = 30 + ((xx + 11 * i) * 170) // (shape[1] + 11 * n) + (yy * 40) // shape[0]
        px = np.clip(base[..., None] + rng.integers(-20, 21, (*shape, 3)), 0, 255)
        if maxval > 255:
            px = px * 16 + rng.integers(0, 16, (*shape, 3))
        out.append(px.astype(np.uint16 if maxval > 255 else np.uint8))
    return out


def _jax_cfg(preset="P420", quality=None):
    return dj.EncoderConfig(chroma_subsampling=dj.ChromaSubsamplingPreset(preset),
                            quality=quality)


def _want(images, maxval=255, cfg=None):
    """The JAX package's encode_array of each image (cached by content)."""
    cfg = cfg or _jax_cfg()
    out = []
    for px in images:
        key = (px.tobytes(), px.shape, maxval, cfg.chroma_subsampling, cfg.quality)
        if key not in _JAX_CACHE:
            _JAX_CACHE[key] = dj.encode_array(px, maxval, cfg)
        out.append(_JAX_CACHE[key])
    return out


def _batch(images, maxval=255, cfg=None):
    return dt.encode_batch(images, maxval, config_from_jax(cfg or _jax_cfg()), device="cpu")


@pytest.fixture
def counts(monkeypatch):
    """Count the calls of phase 1 and of both pack wrappers."""
    calls = {"phase1": 0, "slab_pack": 0, "pack": 0}
    for name, key in (("zigzag_blocks", "phase1"), ("fused_pack_words_slab", "slab_pack"),
                      ("fused_pack_words", "pack")):
        real = getattr(tod, name)

        def counted(*a, _real=real, _key=key, **k):
            calls[_key] += 1
            return _real(*a, **k)

        monkeypatch.setattr(tod, name, counted)
    return calls


@pytest.mark.parametrize("onepack", ["0", "1"])
@pytest.mark.parametrize("preset", ["P420", "P422", "P444"])
def test_start_one_dispatch_slab_matches_jax(monkeypatch, preset, onepack):
    monkeypatch.setenv("DMMT_SLAB_ONEPACK", onepack)
    images = _frames(3, (21, 30), seed=3)
    cfg = _jax_cfg(preset, 85)
    port_cfg = config_from_jax(cfg)
    lq, cq = quantization_table_pair(port_cfg.quantization_preset, port_cfg.quality)
    states = tod.start_one_dispatch_slab(np.stack(images), 255, port_cfg, lq, cq, device="cpu")
    assert len(states) == 3
    for px, st, want in zip(images, states, _want(images, cfg=cfg)):
        scan, tables = tod.finish_one_dispatch(st)
        assert tenc._jpeg(px.shape, port_cfg, lq, cq, scan, tables) == want
        alone = tod.start_one_dispatch(px, 255, port_cfg, lq, cq, device="cpu")
        assert tod.finish_one_dispatch(alone) == (scan, tables)


@pytest.mark.parametrize("depth,n", [(2, 3), (3, 5)])
def test_encode_batch_forced_slab_matches_jax(monkeypatch, counts, depth, n):
    """Groups of `depth` with a trailing single (3 = 2 + 1) and a trailing
    pair (5 = 3 + 2); phase 1 runs once per group."""
    monkeypatch.setenv("DMMT_SLAB_B", str(depth))
    images = _frames(n, (24, 38), seed=n)
    assert _batch(images) == _want(images)
    groups = -(-n // depth)
    assert counts == {"phase1": groups, "slab_pack": 0, "pack": n}


def test_encode_batch_onepack_calls_slab_pack_once_per_group(monkeypatch, counts):
    monkeypatch.setenv("DMMT_SLAB_B", "2")
    monkeypatch.setenv("DMMT_SLAB_ONEPACK", "1")
    images = _frames(5, (24, 38), seed=5)
    assert _batch(images) == _want(images)
    assert counts == {"phase1": 3, "slab_pack": 3, "pack": 0}


def test_encode_batch_default_gate_takes_the_slab(counts):
    images = _frames(3, (24, 38), seed=3)
    assert _batch(images) == _want(images)
    assert counts == {"phase1": 1, "slab_pack": 0, "pack": 3}


def test_encode_batch_no_slab_runs_per_image(monkeypatch, counts):
    monkeypatch.setenv("DMMT_SLAB", "0")
    monkeypatch.setenv("DMMT_SLAB_ONEPACK", "1")  # no effect off the slab
    images = _frames(3, (24, 38), seed=3)
    assert _batch(images) == _want(images)
    assert counts == {"phase1": 3, "slab_pack": 0, "pack": 3}


@pytest.mark.parametrize("upload_depth", ["1", "2", "4"])
def test_encode_batch_mixed_shapes(monkeypatch, counts, upload_depth):
    monkeypatch.setenv("DMMT_UPLOAD_DEPTH", upload_depth)
    images = [*_frames(2, (24, 38), seed=3), *_frames(1, (7, 17), seed=8),
              *_frames(1, (24, 38), seed=9)]
    assert _batch(images) == _want(images)
    assert counts["phase1"] == 4 and counts["slab_pack"] == 0


def test_encode_batch_maxval_4095(monkeypatch):
    monkeypatch.setenv("DMMT_SLAB_B", "2")
    images = _frames(3, (21, 30), seed=12, maxval=4095)
    assert all(px.dtype == np.uint16 for px in images)
    assert _batch(images, 4095) == _want(images, 4095)


@pytest.mark.parametrize("preset", ["P420", "P444"])
def test_encode_batch_odd_size(preset):
    images = _frames(3, (7, 17), seed=13)
    cfg = _jax_cfg(preset)
    assert _batch(images, cfg=cfg) == _want(images, cfg=cfg)


def test_encode_batch_single_and_empty(counts):
    images = _frames(1, (24, 38), seed=14)
    assert _batch(images) == _want(images)
    assert _batch([]) == []
    assert counts["phase1"] == 1


def test_slab_stack_buffer_not_contaminated_across_sizes(monkeypatch):
    """The reused staging buffer is written only in [:h, :w]; batches
    whose true sizes differ but pad to the same size (28x44 then 24x38,
    both 32x48 in P420) must not leak the first batch's pixels into the
    second's black pad. The big batch runs twice, so that every buffer of
    the ring has held it."""
    monkeypatch.setenv("DMMT_SLAB_B", "2")
    big = _frames(2, (28, 44), seed=21)
    small = _frames(2, (24, 38), seed=22)
    for _ in range(2):
        assert _batch(big) == _want(big)
    assert _batch(small) == _want(small)


def test_fused_batch_and_shards_raise(counts):
    """fused_batch=2 encodes (the fused batch: phase 1 once, no slab or
    per-image pack); num_shards > 1 no longer raises: it ignores
    fused_batch, as the JAX package does, and takes the sharded encode
    (test_torch_sharding.py), with the same bytes."""
    images = _frames(2, (8, 8), seed=1)
    assert dt.encode_batch(images, 255, dt.EncoderConfig(), fused_batch=2, device="cpu") == \
        _want(images)
    assert counts == {"phase1": 0, "slab_pack": 0, "pack": 0}
    assert dt.encode_batch(images, 255, dt.EncoderConfig(num_shards=2), fused_batch=2,
                           device="cpu") == _want(images)
    assert counts == {"phase1": 0, "slab_pack": 0, "pack": 0}


def test_slab_depth_gate(monkeypatch):
    cfg = dt.EncoderConfig()
    hd = [np.zeros((1080, 1920, 3), np.uint8)] * 40
    assert tenc.slab_depth(hd, cfg) == tenc.SLAB_B
    assert tenc.slab_depth(hd[:5], cfg) == 5
    assert tenc.slab_depth(hd[:1], cfg) == 1
    assert tenc.slab_depth([hd[0], np.zeros((1080, 1921, 3), np.uint8)], cfg) == 1
    # the group bound is bytes of worst-case words: 48,960 blocks per frame
    per = tod.blocks_per_image(1080, 1920, cfg.chroma_subsampling)
    assert per == 48960
    assert tod.slab_max_blocks() * tod.WORD_BYTES_PER_BLOCK == tod.SLAB_MAX_WORD_BYTES
    monkeypatch.setenv("DMMT_SLAB_MAX_BLOCKS", str(3 * per))
    assert tenc.slab_depth(hd, cfg) == 3
    monkeypatch.setenv("DMMT_SLAB_MAX_BLOCKS", str(per))
    assert tenc.slab_depth(hd, cfg) == 1
    monkeypatch.delenv("DMMT_SLAB_MAX_BLOCKS")
    monkeypatch.setenv("DMMT_SLAB_MAX_ROWS", "1080")
    assert tenc.slab_depth(hd, cfg) == 1  # pads to 1088 rows
    monkeypatch.setenv("DMMT_SLAB_MAX_ROWS", "1088")
    assert tenc.slab_depth(hd, cfg) == tenc.SLAB_B
    monkeypatch.setenv("DMMT_SLAB_B", "7")
    assert tenc.slab_depth(hd, cfg) == 7
    monkeypatch.setenv("DMMT_SLAB", "0")
    assert tenc.slab_depth(hd, cfg) == 1


def test_slab_rejects_unpadded_tensor_and_oversized_group(monkeypatch):
    cfg = dt.EncoderConfig()
    lq, cq = quantization_table_pair(cfg.quantization_preset, cfg.quality)
    with pytest.raises(ValueError, match="MCU-padded"):
        tod.start_one_dispatch_slab(torch.zeros((2, 8, 8, 3), dtype=torch.uint8), 255, cfg, lq,
                                    cq, device="cpu")
    monkeypatch.setenv("DMMT_SLAB_MAX_BLOCKS", "11")
    with pytest.raises(ValueError, match="DMMT_SLAB_MAX_BLOCKS"):
        tod.start_one_dispatch_slab(np.zeros((2, 16, 16, 3), np.uint8), 255, cfg, lq, cq,
                                    device="cpu")
