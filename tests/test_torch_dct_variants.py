"""PyTorch port, the DCT variants SIMPLE, SEPARATED and FUSED.

The port's ops (dct_matrix, dct2d, quantize_zigzag, blockize,
fused_matrix) and the block DCT kernel's plain version are held against
the JAX package's on the CPU; the route of SIMPLE and SEPARATED through
the matmul plane DCT kernel against the JAX variant path; the float32
planes the variants' programs blockize against jitted XLA; and the JPEG
bytes of every variant against the JAX package's. The tolerance is zero
everywhere."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dmmt_jpeg_encoder_tpu as dj
import dmmt_jpeg_encoder_tpu_torch as dt
from dmmt_jpeg_encoder_tpu.ops import dct as jdct
from dmmt_jpeg_encoder_tpu.ops import fused as jfused
from dmmt_jpeg_encoder_tpu.ops import geometry as jgeo
from dmmt_jpeg_encoder_tpu.ops.color import rgb_to_ycbcr
from dmmt_jpeg_encoder_tpu.ops.quantize import quantize_zigzag as jax_quantize_zigzag
from dmmt_jpeg_encoder_tpu.tables import quantization_table_pair
from dmmt_jpeg_encoder_tpu_torch.config import ChromaSubsamplingPreset, config_from_jax
from dmmt_jpeg_encoder_tpu_torch.kernels import build
from dmmt_jpeg_encoder_tpu_torch.ops import color, dct, geometry
from dmmt_jpeg_encoder_tpu_torch.ops.fused import fused_dct_quantize_zigzag, fused_matrix
from dmmt_jpeg_encoder_tpu_torch.ops.mxu_dct import plane_dct_quant_mxu
from dmmt_jpeg_encoder_tpu_torch.ops.quantize import quantize_zigzag
from dmmt_jpeg_encoder_tpu_torch.pipeline import plane_to_zigzag_blocks
from torch_port_fixtures import (
    FIXTURES,
    ROUTES,
    SMALL_FIXTURES,
    fixture_pixels,
    load_route_goldens,
    route_env,
    sha256,
)

VARIANTS = ["simple", "separated", "fused"]
PRESETS = ["P420", "P422", "P444"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the plain versions' small tensors gain nothing
    from more, and the parallel test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _blocks(seed, n=300, scale=80.0):
    return (np.random.default_rng(seed).standard_normal((n, 8, 8)) * scale).astype(np.float32)


def _tables(qtable="Specification", quality=None):
    return quantization_table_pair(dj.QuantizationTablePreset(qtable), quality)


def _pixels(seed, shape, maxval):
    rng = np.random.default_rng(seed)
    dtype = np.uint8 if maxval <= 255 else np.uint16
    yy, xx = np.mgrid[0 : shape[0], 0 : shape[1]]
    base = (xx * maxval) // max(shape[1] - 1, 1) // 2 + (yy * maxval) // max(shape[0] - 1, 1) // 4
    noise = rng.integers(-(maxval // 10), maxval // 10 + 1, (*shape, 3))
    return np.clip(base[..., None] + noise, 0, maxval).astype(dtype)


@pytest.mark.parametrize("variant", ["simple", "separated"])
def test_dct2d_matches_jax(variant):
    blocks = _blocks(1)
    want = jax.jit(lambda b: jdct.dct2d(b, dj.DCTVariant(variant)))(jnp.asarray(blocks))
    got = dct.dct2d(torch.from_numpy(blocks))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(dct.dct_matrix(), jdct.dct_matrix())


def test_quantize_zigzag_matches_jax():
    coeffs = _blocks(2, scale=300.0)
    for q in _tables() + _tables("Flat", 90):
        want = jax.jit(jax_quantize_zigzag)(jnp.asarray(coeffs), jnp.asarray(q))
        got = quantize_zigzag(torch.from_numpy(coeffs), torch.from_numpy(q))
        assert got.dtype == torch.int16
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_blockize_matches_jax():
    plane = np.arange(32 * 48, dtype=np.float32).reshape(32, 48)
    t = torch.from_numpy(plane)
    np.testing.assert_array_equal(geometry.blockize(t).numpy(), np.asarray(jgeo.blockize(plane)))
    np.testing.assert_array_equal(geometry.entangled_blockize_p420(t).numpy(),
                                  np.asarray(jgeo.entangled_blockize_p420(plane)))


@pytest.mark.parametrize("qtable,quality", [("Specification", None), ("Flat", 50),
                                            ("MSSIM-Kodak-Tuned", 95)])
def test_fused_matrix_and_plain_match_jax(qtable, quality):
    """fused_matrix and K11's plain version (one sequential fma chain per
    output) against fused_matrix and fused_reference."""
    for q in _tables(qtable, quality):
        np.testing.assert_array_equal(fused_matrix(q), np.asarray(jfused.fused_matrix(jnp.asarray(q))))
        for n, seed in ((64, 3), (500, 4)):
            blocks = _blocks(seed, n)
            want = jax.jit(jfused.fused_reference)(jnp.asarray(blocks), jnp.asarray(q))
            got = fused_dct_quantize_zigzag(torch.from_numpy(blocks), q)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("variant", ["simple", "separated"])
@pytest.mark.parametrize("entangle", [True, False])
def test_matmul_variants_route_through_the_plane_kernel(variant, entangle):
    """SIMPLE and SEPARATED run the matmul plane DCT kernel on the plane:
    its blocks equal the JAX variant path's quantize_zigzag(dct2d(blockize))."""
    plane = (np.random.default_rng(7).standard_normal((48, 64)) * 70).astype(np.float32)
    q = _tables()[0]
    blockize = jgeo.entangled_blockize_p420 if entangle else jgeo.blockize
    want = jax.jit(lambda p, t: jax_quantize_zigzag(jdct.dct2d(blockize(p), dj.DCTVariant(variant)), t))(
        jnp.asarray(plane), jnp.asarray(q))
    got = plane_to_zigzag_blocks(plane_dct_quant_mxu(torch.from_numpy(plane), torch.from_numpy(q)),
                                 entangle)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("channel", [0, 1, 2])
def test_variant_planes_match_xla(preset, channel):
    """The float32 blocks the variants' programs transform: color, the
    plane path's subsample (scale by 255 fused into its adds), blockize,
    then the SIMPLE contraction, jitted as one program."""
    rgb = np.random.default_rng(channel).integers(0, 256, (32, 48, 3)).astype(np.float32) / np.float32(255)
    p = dj.ChromaSubsamplingPreset(preset)

    def program(x):
        plane = rgb_to_ycbcr(x)[channel]
        if channel:
            plane = jgeo.subsample(plane, p)
        return jdct.dct2d(jgeo.blockize(plane), dj.DCTVariant.SIMPLE)

    want = jax.jit(program)(jnp.asarray(rgb))
    r, g, b = torch.from_numpy(rgb).unbind(-1)
    plane = color.luma(r, g, b) if channel == 0 else geometry.subsample_scaled(
        color.chroma_sums(r, g, b)[channel - 1], ChromaSubsamplingPreset(preset))
    got = dct.dct2d(geometry.blockize(plane))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _variant_cfg(variant, preset, qtable="Specification", quality=None):
    return dj.EncoderConfig(chroma_subsampling=dj.ChromaSubsamplingPreset(preset),
                            quantization_preset=dj.QuantizationTablePreset(qtable), quality=quality,
                            dct_variant=dj.DCTVariant(variant))


@pytest.mark.parametrize("one_dispatch", ["auto", "off"])
@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("variant", VARIANTS)
def test_encode_array_bytes_match_jax(variant, preset, one_dispatch):
    px = _pixels(11, (37, 53), 255)
    cfg = _variant_cfg(variant, preset)
    port = dataclasses.replace(config_from_jax(cfg), one_dispatch=one_dispatch)
    assert dt.encode_array(px, 255, port, device="cpu") == dj.encode_array(px, 255, cfg)


@pytest.mark.parametrize("variant", VARIANTS)
def test_encode_array_bytes_match_jax_maxval_4095(variant):
    px = _pixels(12, (29, 41), 4095)
    cfg = _variant_cfg(variant, "P422", "PSNR-HVS-N-Kodak-Tuned", 70)
    assert dt.encode_array(px, 4095, config_from_jax(cfg), device="cpu") == dj.encode_array(px, 4095, cfg)


@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_bytes_differ_from_arai_and_match_jax(variant):
    """An input where the variant rounds some coefficient otherwise than
    ARAI (noise, maxval 4095, quality 100): the port follows the JAX
    package into the different bytes."""
    px = np.random.default_rng(1).integers(0, 4096, (128, 192, 3)).astype(np.uint16)
    cfg = dj.EncoderConfig(quality=100, dct_variant=dj.DCTVariant(variant))
    want = dj.encode_array(px, 4095, cfg)
    assert want != dj.encode_array(px, 4095, dj.EncoderConfig(quality=100))
    assert dt.encode_array(px, 4095, config_from_jax(cfg), device="cpu") == want


@pytest.mark.parametrize("variant", ["simple", "fused"])
def test_encode_batch_bytes_match_jax(variant):
    """The slab (blockize and the P420 entangle over the row-stacked
    frames) and fused_batch=2."""
    frames = [_pixels(50 + i, (45, 71), 255) for i in range(3)]
    cfg = _variant_cfg(variant, "P420")
    want = [dj.encode_array(px, 255, cfg) for px in frames]
    port = config_from_jax(cfg)
    assert dt.encode_batch(frames, 255, port, device="cpu") == want
    assert dt.encode_batch(frames, 255, port, fused_batch=2, device="cpu") == want


def test_block_dct_wrapper_refuses_other_devices():
    with pytest.raises(ValueError):
        fused_dct_quantize_zigzag(torch.zeros((2, 8, 8), device="meta"), np.ones(64, np.uint8))
    assert "block_dct_zz" in build.LAUNCHES


@pytest.mark.parametrize("name", SMALL_FIXTURES)
@pytest.mark.parametrize("route", [r for r in ROUTES if r.startswith("dct_")])
def test_route_goldens_small_fixtures(route, name):
    """The port's CPU bytes of the DCT-variant routes equal the JAX goldens that
    chip_smoke.py holds the card's output against."""
    f = FIXTURES[name]
    cfg = dt.EncoderConfig(chroma_subsampling=dt.ChromaSubsamplingPreset(f["preset"]),
                           quality=f["quality"], dct_variant=dt.DCTVariant(ROUTES[route][1]))
    with route_env(route):
        jpeg = dt.encode_array(fixture_pixels(name), f["maxval"], cfg, device="cpu")
    assert sha256(jpeg) == load_route_goldens()[0][route][name]["jpeg_sha256"]
