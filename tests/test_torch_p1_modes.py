"""PyTorch port, the DMMT_P1 phase-1 routes of the ARAI variant: pallas
(the plane DCT kernel), mxu (the matmul plane DCT kernel) and fused1 (the
fused matmul phase-1 kernel).

Each kernel's plain version is held against its JAX counterpart on the
CPU, the float32 stages of the fused1 reference against jitted XLA, and
the JPEG bytes of every route against the JAX package's under the same
DMMT_P1 (DMMT_P1_PREC=high: test_torch_p1_precision_high.py). The
tolerance is zero everywhere."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dmmt_jpeg_encoder_tpu as dj
import dmmt_jpeg_encoder_tpu_torch as dt
from dmmt_jpeg_encoder_tpu import pipeline as jpipe
from dmmt_jpeg_encoder_tpu.ops import fused_phase1 as jfused1
from dmmt_jpeg_encoder_tpu.ops import mxu_dct as jmxu
from dmmt_jpeg_encoder_tpu.ops import pallas_dct as jpallas
from dmmt_jpeg_encoder_tpu.ops.dct import dct_matrix as jax_dct_matrix
from dmmt_jpeg_encoder_tpu.tables import quantization_table_pair
from dmmt_jpeg_encoder_tpu_torch.config import ChromaSubsamplingPreset, config_from_jax
from dmmt_jpeg_encoder_tpu_torch.kernels import build
from dmmt_jpeg_encoder_tpu_torch.ops import color, dct, geometry
from dmmt_jpeg_encoder_tpu_torch.ops.fused_phase1 import fused_phase1
from dmmt_jpeg_encoder_tpu_torch.ops.mxu_dct import plane_dct_quant_mxu
from dmmt_jpeg_encoder_tpu_torch.ops.pallas_dct import plane_dct_quant
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

MODES = ["pallas", "mxu", "fused1"]
PRESETS = ["P420", "P422", "P444"]
RATES = {"P444": (1, 1), "P422": (2, 1), "P420": (2, 2)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the plain versions' small tensors gain nothing
    from more, and the parallel test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plane(seed, h, w, scale=60.0):
    return (np.random.default_rng(seed).standard_normal((h, w)) * scale).astype(np.float32)


def _tables(qtable="Specification"):
    return quantization_table_pair(dj.QuantizationTablePreset(qtable))


def _pixels(seed, shape, maxval):
    rng = np.random.default_rng(seed)
    dtype = np.uint8 if maxval <= 255 else np.uint16
    yy, xx = np.mgrid[0 : shape[0], 0 : shape[1]]
    base = (xx * maxval) // max(shape[1] - 1, 1) // 2 + (yy * maxval) // max(shape[0] - 1, 1) // 4
    noise = rng.integers(-(maxval // 10), maxval // 10 + 1, (*shape, 3))
    return np.clip(base[..., None] + noise, 0, maxval).astype(dtype)


@pytest.mark.parametrize("table", [0, 1])
def test_plane_dct_plain_matches_pallas_kernel_and_plane_path(monkeypatch, table):
    """K8's plain version against the JAX Pallas kernel in interpret mode
    and against the JAX plane path's DCT stage, at 64x96."""
    monkeypatch.setenv("DMMT_PALLAS_INTERPRET", "1")
    plane, q = _plane(10 + table, 64, 96), _tables()[table]
    got = plane_dct_quant(torch.from_numpy(plane), torch.from_numpy(q))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jpallas.plane_dct_quant(jnp.asarray(plane), jnp.asarray(q))))
    want = jax.jit(lambda p, t: jpipe._plane_dct_zigzag_blocks(p, t, True, "plane"))(
        jnp.asarray(plane), jnp.asarray(q))
    np.testing.assert_array_equal(plane_to_zigzag_blocks(got, True).numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [(64, 96), (256, 384)])
def test_mxu_plain_matches_reference(shape):
    """K9's plain version against mxu_dct_reference."""
    plane = _plane(sum(shape), *shape)
    for q in _tables("Flat") + _tables():
        want = jax.jit(jmxu.mxu_dct_reference)(jnp.asarray(plane), jnp.asarray(q))
        got = plane_dct_quant_mxu(torch.from_numpy(plane), torch.from_numpy(q))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [(64, 96), (256, 384)])
def test_mxu_contraction_floats_match_xla(shape):
    """The summation order of ops/dct.contract8, column pass first: the
    float32 coefficients equal the reference's HIGHEST einsum bit for bit
    (the row pass first matches only about a third of them)."""
    h, w = shape
    plane = _plane(sum(shape) + 1, h, w)
    c = jnp.asarray(jax_dct_matrix())
    want = jax.jit(lambda p: jnp.einsum("vy,aybx,ux->avbu", c, p.reshape(h // 8, 8, w // 8, 8), c,
                                        precision=jax.lax.Precision.HIGHEST))(jnp.asarray(plane))
    x = torch.from_numpy(plane).reshape(h // 8, 8, w // 8, 8)
    got = dct.matmul_dct_pass(dct.matmul_dct_pass(x, 1), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(dct.dct_matrix(), jax_dct_matrix())


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("maxval", [255, 4095])
def test_fused_phase1_plain_matches_reference(preset, maxval):
    """K10's plain version against fused_phase1_reference, on an odd-size
    image (the JAX function takes the planes padded to the MCU multiple)."""
    hr, vr = RATES[preset]
    px = _pixels(maxval + hr + vr, (37, 53), maxval)
    p = ChromaSubsamplingPreset(preset)
    ph, pw = geometry.padded_size(37, 53, p)
    planes = [jnp.pad(jnp.asarray(px[..., i]), ((0, ph - 37), (0, pw - 53))) for i in range(3)]
    lq, cq = _tables()
    want = jax.jit(lambda r, g, b, m, l, c: jfused1.fused_phase1_reference(r, g, b, m, l, c, hr, vr))(
        *planes, jnp.float32(maxval), jnp.asarray(lq), jnp.asarray(cq))
    got = fused_phase1(torch.from_numpy(px), maxval, torch.from_numpy(lq), torch.from_numpy(cq), p)
    for a, b in zip(got, want):
        assert a.dtype == torch.int16
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("maxval", [255, 4095])
def test_fused_phase1_stage_floats_match_xla(monkeypatch, preset, maxval):
    """The float32 planes fused_phase1_reference hands its DCT: x * (1 /
    maxval), the color sums and the pair-sum subsample with the scale by
    255 fused into the first pair add (geometry.subsample_pairs_scaled)."""
    monkeypatch.setattr(jmxu, "mxu_dct_reference", lambda plane, q: plane)
    hr, vr = RATES[preset]
    dtype = np.uint8 if maxval <= 255 else np.uint16
    rgb = np.random.default_rng(maxval + vr).integers(0, maxval + 1, (3, 64, 96)).astype(dtype)
    q = jnp.ones(64, jnp.uint8)
    want = jax.jit(lambda r, g, b, m: jfused1.fused_phase1_reference(r, g, b, m, q, q, hr, vr))(
        *(jnp.asarray(c) for c in rgb), jnp.float32(maxval))
    t = torch.from_numpy(rgb.astype(np.int32)).to(torch.float32)
    inv = color.f32(1.0) / color.f32(maxval)
    r, g, b = t * inv
    p = ChromaSubsamplingPreset(preset)
    got = (color.luma(r, g, b), *(geometry.subsample_pairs_scaled(c, p) for c in color.chroma_sums(r, g, b)))
    for a, e in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(e))


def _route_bytes(monkeypatch, mode, preset, shape, maxval, qtable="Specification", quality=None):
    monkeypatch.setenv("DMMT_P1", mode)
    px = _pixels(sum(shape) + maxval, shape, maxval)
    cfg = dj.EncoderConfig(chroma_subsampling=dj.ChromaSubsamplingPreset(preset),
                           quantization_preset=dj.QuantizationTablePreset(qtable), quality=quality)
    return px, cfg, dj.encode_array(px, maxval, cfg)


@pytest.mark.parametrize("one_dispatch", ["auto", "off"])
@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("mode", MODES)
def test_encode_array_bytes_match_jax(monkeypatch, mode, preset, one_dispatch):
    px, cfg, want = _route_bytes(monkeypatch, mode, preset, (37, 53), 255)
    port = dataclasses.replace(config_from_jax(cfg), one_dispatch=one_dispatch)
    assert dt.encode_array(px, 255, port, device="cpu") == want


@pytest.mark.parametrize("mode", MODES)
def test_encode_array_bytes_match_jax_maxval_4095(monkeypatch, mode):
    px, cfg, want = _route_bytes(monkeypatch, mode, "P420", (29, 41), 4095, "Flat", 60)
    assert dt.encode_array(px, 4095, config_from_jax(cfg), device="cpu") == want


@pytest.mark.parametrize("mode", ["mxu", "fused1"])
def test_route_bytes_differ_from_the_default_and_match_jax(monkeypatch, mode):
    """An input where the route rounds some coefficient otherwise than
    the Arai default (noise, maxval 4095, quality 100): the port follows
    the JAX package into the different bytes."""
    px = np.random.default_rng(1).integers(0, 4096, (128, 192, 3)).astype(np.uint16)
    cfg = dj.EncoderConfig(quality=100)
    default = dj.encode_array(px, 4095, cfg)
    monkeypatch.setenv("DMMT_P1", mode)
    want = dj.encode_array(px, 4095, cfg)
    assert want != default
    assert dt.encode_array(px, 4095, config_from_jax(cfg), device="cpu") == want


@pytest.mark.parametrize("mode", ["mxu", "fused1"])
def test_encode_batch_bytes_match_jax(monkeypatch, mode):
    """The slab (one phase-1 call over the row-stacked frames: the pair
    sums and 8x8 groups never straddle two images) and fused_batch=2."""
    monkeypatch.setenv("DMMT_P1", mode)
    frames = [_pixels(40 + i, (45, 71), 255) for i in range(3)]
    cfg = dj.EncoderConfig(chroma_subsampling=dj.ChromaSubsamplingPreset.P420)
    want = [dj.encode_array(px, 255, cfg) for px in frames]
    port = config_from_jax(cfg)
    assert dt.encode_batch(frames, 255, port, device="cpu") == want
    assert dt.encode_batch(frames, 255, port, fused_batch=2, device="cpu") == want


def test_layout_modes_take_the_default_route(monkeypatch):
    """plane_mm, plane2, block, fused2 and unknown values take the default
    route (the phase-1 kernel): the default bytes."""
    px = _pixels(3, (24, 40), 255)
    want = dt.encode_array(px, 255, device="cpu")
    for mode in ("plane", "plane_mm", "plane2", "block", "fused2", "no-such-mode"):
        monkeypatch.setenv("DMMT_P1", mode)
        assert dt.encode_array(px, 255, device="cpu") == want


def test_p1_precision_refusals(monkeypatch):
    """DMMT_P1_PREC on the mxu and fused1 routes: "medium" raises
    ValueError, "high" encodes with the JAX package's bytes, "highest"
    encodes; the other routes do not read it, as in the JAX package."""
    px = _pixels(4, (16, 16), 255)
    for mode in ("mxu", "fused1"):
        monkeypatch.setenv("DMMT_P1", mode)
        monkeypatch.setenv("DMMT_P1_PREC", "high")
        assert dt.encode_array(px, 255, device="cpu") == dj.encode_array(px, 255)
        monkeypatch.setenv("DMMT_P1_PREC", "medium")
        with pytest.raises(ValueError, match="DMMT_P1_PREC"):
            dt.encode_array(px, 255, device="cpu")
        monkeypatch.setenv("DMMT_P1_PREC", "highest")
        dt.encode_array(px, 255, device="cpu")
    # the other routes do not read it, as in the JAX package
    monkeypatch.setenv("DMMT_P1_PREC", "high")
    monkeypatch.setenv("DMMT_P1", "pallas")
    want = dj.encode_array(px, 255)
    assert dt.encode_array(px, 255, device="cpu") == want
    assert dt.encode_array(px, 255, dt.EncoderConfig(dct_variant=dt.DCTVariant.FUSED),
                           device="cpu") == dj.encode_array(
        px, 255, dj.EncoderConfig(dct_variant=dj.DCTVariant.FUSED))


def test_cli_refuses_p1_precision_high(monkeypatch, tmp_path):
    """The CLI under DMMT_P1_PREC: "high" writes the JAX CLI's bytes,
    "highest" encodes, and a value that is neither exits with code 1."""
    from dmmt_jpeg_encoder_tpu import cli as jax_cli
    from dmmt_jpeg_encoder_tpu.io.ppm import write_ppm
    from dmmt_jpeg_encoder_tpu_torch import cli as port_cli

    src, out, want = tmp_path / "in.ppm", tmp_path / "out.jpg", tmp_path / "want.jpg"
    write_ppm(src, _pixels(5, (16, 16), 255))
    monkeypatch.setenv("DMMT_P1", "mxu")
    monkeypatch.setenv("DMMT_P1_PREC", "high")
    assert port_cli.main([str(src), str(out), "--device", "cpu"]) == 0
    assert jax_cli.main([str(src), str(want)]) == 0
    assert out.read_bytes() == want.read_bytes()
    out.unlink()
    monkeypatch.setenv("DMMT_P1_PREC", "medium")
    assert port_cli.main([str(src), str(out), "--device", "cpu"]) == 1
    assert not out.exists()
    monkeypatch.setenv("DMMT_P1_PREC", "highest")
    assert port_cli.main([str(src), str(out), "--device", "cpu"]) == 0


def test_wrappers_refuse_other_devices():
    plane = torch.zeros((8, 8), dtype=torch.float32, device="meta")
    q = torch.ones(64, dtype=torch.uint8)
    for fn in (plane_dct_quant, plane_dct_quant_mxu):
        with pytest.raises(ValueError):
            fn(plane, q)
    with pytest.raises(ValueError):
        fused_phase1(torch.zeros((8, 8, 3), dtype=torch.uint8, device="meta"), 255, q, q,
                     ChromaSubsamplingPreset.P444)
    assert {"plane_dct", "plane_dct_mm", "phase1_mm"} <= set(build.LAUNCHES)


@pytest.mark.parametrize("name", SMALL_FIXTURES)
@pytest.mark.parametrize("route", [r for r in ROUTES if r.startswith("p1_")])
def test_route_goldens_small_fixtures(route, name):
    """The port's CPU bytes of the DMMT_P1 routes equal the JAX goldens that
    chip_smoke.py holds the card's output against."""
    f = FIXTURES[name]
    cfg = dt.EncoderConfig(chroma_subsampling=dt.ChromaSubsamplingPreset(f["preset"]),
                           quality=f["quality"], dct_variant=dt.DCTVariant(ROUTES[route][1]))
    with route_env(route):
        jpeg = dt.encode_array(fixture_pixels(name), f["maxval"], cfg, device="cpu")
    assert sha256(jpeg) == load_route_goldens()[0][route][name]["jpeg_sha256"]
