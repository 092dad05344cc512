"""PyTorch port, the multi-device encode's pieces (parallel/sharding.py)
and the scan-pack kernels' `valid` mask, against the JAX package on the
CPU, exactly (every result is an integer): the shard geometry, the
bit-merge, the alignment drop, the masked scan packs against the JAX
package's masked staged pack, run_sharded_pipeline against the JAX
package's on its virtual 8-device CPU mesh, the sharded slab gate, the
device list, and the capability probe on the CPU. The bytes of the
sharded encodes are in test_torch_sharded_encode.py."""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dmmt_jpeg_encoder_tpu as dj
import dmmt_jpeg_encoder_tpu_torch as dt
from dmmt_jpeg_encoder_tpu.bitstream import device_pack as jpack
from dmmt_jpeg_encoder_tpu.parallel import sharding as jshard
from dmmt_jpeg_encoder_tpu_torch import encoder as tenc
from dmmt_jpeg_encoder_tpu_torch.bitstream import device_pack as tpack
from dmmt_jpeg_encoder_tpu_torch.bitstream.fused_pack import fused_pack_words, fused_pack_words_slab
from dmmt_jpeg_encoder_tpu_torch.config import config_from_jax
from dmmt_jpeg_encoder_tpu_torch.parallel import sharding as tshard
from dmmt_jpeg_encoder_tpu_torch.utils import capability
from test_torch_pack import _scan_case


def _image(seed, shape, maxval=255):
    rng = np.random.default_rng(seed)
    px = rng.integers(0, maxval + 1, (*shape, 3))
    return px.astype(np.uint8 if maxval <= 255 else np.uint16)


def _cfg(preset="P420", n=1, **kw):
    return dj.EncoderConfig(chroma_subsampling=dj.ChromaSubsamplingPreset(preset), num_shards=n, **kw)


@pytest.fixture
def capable(monkeypatch):
    """The devices run the kernels (on the CPU: their plain versions)."""
    monkeypatch.setattr(capability, "kernels_capable", lambda device: True)


# --- geometry, merge, alignment -----------------------------------------------


@pytest.mark.parametrize("h,w,preset,n", [(128, 32, "P420", 8), (500, 500, "P420", 8),
                                          (48, 32, "P420", 8), (7, 17, "P444", 2),
                                          (333, 1001, "P422", 4), (2160, 3840, "P420", 2)])
def test_shard_geometry_matches_jax(h, w, preset, n):
    p = dj.ChromaSubsamplingPreset(preset)
    assert tshard.shard_geometry(h, w, dt.ChromaSubsamplingPreset(preset), n) == \
        jshard._shard_geometry(h, w, p, n)


def test_merge_bit_streams_matches_jax():
    rng = np.random.default_rng(5)
    for trial in range(20):
        chunks = []
        for _ in range(int(rng.integers(1, 6))):
            bits = int(rng.choice([0, 1, 7, 8, 9, 31, 32, 33, int(rng.integers(0, 300))]))
            data = rng.integers(0, 256, (bits + 7) // 8 + 4).astype(np.uint8)
            if bits % 8:  # bits past the length are zero, as the packers leave them
                data[bits // 8] &= (0xFF << (8 - bits % 8)) & 0xFF
            data[(bits + 7) // 8:] = 0
            chunks.append((data, bits))
        got, got_bits = tshard.merge_bit_streams(chunks)
        want, want_bits = jshard.merge_bit_streams(chunks)
        assert got_bits == want_bits
        np.testing.assert_array_equal(got, want)
        assert tshard.merge_and_stuff(chunks) == jshard._merge_and_stuff(chunks)


@pytest.mark.parametrize("n,rows,valid,per_row", [(2, 3, 5, 4), (8, 1, 3, 6), (4, 2, 8, 2)])
def test_drop_alignment_blocks_matches_jax(n, rows, valid, per_row):
    blocks = np.arange(n * rows * per_row * 2).reshape(-1, 2)
    np.testing.assert_array_equal(tshard.drop_alignment_blocks(blocks, n, rows, valid, per_row),
                                  jshard._drop_alignment_blocks(blocks, n, rows, valid, per_row))


# --- the scan-pack kernels' valid mask ----------------------------------------------


@partial(jax.jit, static_argnames="n_words")
def _jax_masked_pack(scan, table_idx, dc_comb, ac_comb, mask, n_words):
    """The JAX package's staged sharded pack (sharding.py:856-867): lengths
    and block bits multiplied by the mask, then pack_to_words."""
    vals, lens, offs, bits = jpack.block_emissions(scan, table_idx, dc_comb, ac_comb)
    words, total = jpack.pack_to_words(vals, lens * mask[:, None], offs, bits * mask, n_words)
    return jpack.byteswap_words(words), total


def _masks(n, seed):
    rng = np.random.default_rng(seed)
    return {"prefix": np.arange(n) < (2 * n) // 3, "none": np.zeros(n, bool),
            "all": np.ones(n, bool), "general": rng.random(n) < 0.6}


@pytest.mark.parametrize("lpm,n_mcu,seed", [(1, 40, 0), (4, 25, 2), (2, 30, 1)])
def test_scan_pack_valid_mask_matches_jax_staged_pack(lpm, n_mcu, seed):
    _, _, tables, codes, lens, scan = _scan_case(lpm, n_mcu, seed)
    n = int(scan.shape[0])
    n_words = n * 64 + 2
    is_chroma = ((np.arange(n) % (lpm + 2)) >= lpm).astype(np.int32)
    dc_comb = np.concatenate([jpack.combine_tables(t[0][:16], t[1][:16]) for t in tables[0::2]])
    ac_comb = np.concatenate([jpack.combine_tables(t[0], t[1]) for t in tables[1::2]])
    codes_t, lens_t = torch.from_numpy(codes), torch.from_numpy(lens)
    for name, mask in _masks(n, seed).items():
        jw, jbits = _jax_masked_pack(jnp.asarray(scan.numpy()), jnp.asarray(is_chroma),
                                     jnp.asarray(dc_comb), jnp.asarray(ac_comb),
                                     jnp.asarray(mask.astype(np.int32)), n_words=n_words)
        for valid in (torch.from_numpy(mask), torch.from_numpy(mask.astype(np.int32))):
            words, bits = fused_pack_words(scan, lpm + 2, lpm, codes_t, lens_t, n_words, valid=valid)
            assert int(bits) == int(jbits), name
            np.testing.assert_array_equal(words.numpy(), np.asarray(jw).view(np.int32))
        # the staged arm gives the same stream
        sw, sbits = tpack.staged_pack_words(scan, lpm + 2, lpm, codes_t, lens_t,
                                            (int(jbits) + 31) // 32 + 2,
                                            valid=torch.from_numpy(mask))
        assert int(sbits) == int(jbits)
        np.testing.assert_array_equal(sw.numpy(), np.asarray(jw).view(np.int32)[: sw.shape[0]])
    # no mask equals an all-true mask
    plain = fused_pack_words(scan, lpm + 2, lpm, codes_t, lens_t, n_words)
    masked = fused_pack_words(scan, lpm + 2, lpm, codes_t, lens_t, n_words,
                              valid=torch.ones(n, dtype=torch.int32))
    assert all(torch.equal(a, b) for a, b in zip(plain, masked))


def test_slab_scan_pack_valid_mask_matches_per_image_packs():
    cases = [_scan_case(2, 30, s) for s in (7, 8, 9)]
    scans = torch.stack([c[5] for c in cases])
    codes = torch.from_numpy(np.stack([c[3] for c in cases]))
    lens = torch.from_numpy(np.stack([c[4] for c in cases]))
    n = int(scans.shape[1])
    masks = torch.from_numpy(np.stack([_masks(n, 3)[k] for k in ("prefix", "none", "general")]))
    words, bits = fused_pack_words_slab(scans, 4, 2, codes, lens, n * 64 + 2, valid=masks)
    for i in range(3):
        w, b = fused_pack_words(scans[i], 4, 2, codes[i], lens[i], n * 64 + 2, valid=masks[i])
        assert torch.equal(words[i], w) and int(bits[i]) == int(b)
    assert int(bits[1]) == 0 and not words[1].any()


def test_valid_mask_guards():
    scan = torch.zeros((3, 64), dtype=torch.int16)
    t = torch.zeros((4, 256), dtype=torch.int32)
    with pytest.raises(ValueError, match="valid mask"):
        fused_pack_words(scan, 3, 1, t, t, 3 * 64 + 2, valid=torch.ones(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="valid mask"):
        fused_pack_words_slab(scan[None], 3, 1, t[None], t[None], 3 * 64 + 2,
                              valid=torch.ones(3, dtype=torch.int32))


# --- run_sharded_pipeline ----------------------------------------------------------


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("rows", [8, 3])
@pytest.mark.parametrize("preset", ["P420", "P422", "P444"])
def test_run_sharded_pipeline_matches_jax(preset, rows, n):
    """Blocks (alignment dropped) and summed histograms, divisible (8 MCU
    rows) and not (3 MCU rows: 8 shards leave 5 of pure padding)."""
    p = dj.ChromaSubsamplingPreset(preset)
    px = _image(rows + n, (rows * p.mcu_height - 3, 37))
    want = jshard.run_sharded_pipeline(px, 255, _cfg(preset, n))
    got = tshard.run_sharded_pipeline(px, 255, config_from_jax(_cfg(preset, n)), device="cpu")
    for field in ("luma", "cb", "cr"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)))
    for field in ("luma_dc_hist", "luma_ac_hist", "chroma_dc_hist", "chroma_ac_hist"):
        np.testing.assert_array_equal(getattr(got, field), np.asarray(getattr(want, field)))


# --- the gate, the device list, the probe ------------------------------------------


def test_sharded_slab_gate_and_bound(capable, monkeypatch):
    cfg = dt.EncoderConfig(num_shards=2)
    hd = [np.zeros((1080, 1920, 3), np.uint8)] * 40
    devices = [torch.device("cpu")] * 2
    geom = tshard.Geometry.of(1080, 1920, cfg.chroma_subsampling, 2)
    assert geom.n_scan == 34 * 360 * 2  # 34 MCU rows of 120 MCUs of 6 blocks per shard
    assert tenc.slab_depth(hd, cfg, devices) == tenc.SLAB_B
    monkeypatch.setenv("DMMT_SLAB_MAX_BLOCKS", str(3 * geom.n_scan))
    assert tenc.slab_depth(hd, cfg, devices) == 3
    with pytest.raises(ValueError, match="group bound"):
        tshard.start_sharded_encode_slab(np.zeros((4, 1080, 1920, 3), np.uint8), 255, cfg, "cpu")
    monkeypatch.setenv("DMMT_SLAB_MAX_ROWS", "543")
    assert tenc.slab_depth(hd, cfg, devices) == 1  # a shard holds 544 rows
    monkeypatch.delenv("DMMT_SLAB_MAX_ROWS")
    # one_dispatch is not read on the sharded path, as in the JAX package
    assert tenc.slab_depth(hd, dataclasses.replace(cfg, one_dispatch="off"), devices) == 3
    monkeypatch.setenv("DMMT_NO_FUSED_PACK", "1")
    assert tenc.slab_depth(hd, cfg, devices) == 1


def test_shard_devices():
    assert tshard.shard_devices("cpu", 3) == [torch.device("cpu")] * 3
    assert tshard.shard_devices(["cuda:0", "cuda:0"], 2) == [torch.device("cuda", 0)] * 2
    with pytest.raises(ValueError, match="2 devices given"):
        tshard.shard_devices(["cpu", "cpu"], 3)
    with pytest.raises(ValueError, match="at least 1"):
        tshard.shard_devices("cpu", 0)


def test_too_few_cards_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    px = _image(3, (16, 16))
    for device in ("cuda", "cuda:0", torch.device("cuda")):
        with pytest.raises(ValueError, match="exceeds available devices"):
            dt.encode_array(px, 255, dt.EncoderConfig(num_shards=2), device=device)
    with pytest.raises(ValueError, match="exceeds available devices"):
        dt.encode_batch([px, px], 255, dt.EncoderConfig(num_shards=2), device="cuda")


def test_kernels_capable_and_probe_on_the_cpu():
    assert capability.kernels_capable("cpu") is False
    assert capability.kernels_capable(torch.device("cpu")) is False
    x = torch.arange(8 * 128, dtype=torch.float32).reshape(8, 128)
    assert torch.equal(capability.probe_add_one(x), x + 1)
    with pytest.raises(ValueError):
        capability.probe_add_one(x.to(torch.int32))
