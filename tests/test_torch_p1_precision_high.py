"""PyTorch port, DMMT_P1_PREC=high: the bf16x3 split of the matmul DCT
(ops/mxu_dct.dot_p1) on the mxu and fused1 routes.

The JAX reference's bits under "high" are those of XLA's CPU dot of bf16
operands with a float32 result, which on a host with AVX512-BF16
(VDPBF16PS) sums the 8 exact products of a contraction as a float32 chain
over terms 1, 0, 3, 2, 5, 4, 7, 6. The first test pins that assumption on
this host; the others hold the port's plain versions and JPEG bytes
against the JAX package under "high", and the paths that ignore the
variable to their bytes under "highest". Inputs come from seeded
integer-only numpy. The tolerance is zero everywhere."""

import dataclasses
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dmmt_jpeg_encoder_tpu as dj
import dmmt_jpeg_encoder_tpu_torch as dt
from dmmt_jpeg_encoder_tpu.ops import fused_phase1 as jfused1
from dmmt_jpeg_encoder_tpu.ops import mxu_dct as jmxu
from dmmt_jpeg_encoder_tpu_torch import onedispatch as tod
from dmmt_jpeg_encoder_tpu_torch.config import ChromaSubsamplingPreset, config_from_jax
from dmmt_jpeg_encoder_tpu_torch.encoder import _jpeg
from dmmt_jpeg_encoder_tpu_torch.ops import geometry
from dmmt_jpeg_encoder_tpu_torch.ops.fused_phase1 import fused_phase1
from dmmt_jpeg_encoder_tpu_torch.ops.mxu_dct import (
    DCT_MATRIX,
    DCT_SPLIT,
    PAIR_ORDER,
    check_p1_precision,
    dot_bf16_pairs,
    dot_p1,
    plane_dct_quant_mxu,
    split_bf16,
)
from dmmt_jpeg_encoder_tpu_torch.tables import quantization_table_pair
from torch_port_fixtures import plane_mm_edge_inputs

RATES = {"P444": (1, 1), "P422": (2, 1), "P420": (2, 2)}
# the sha256 prefixes of the JAX package's bytes of the noise image under
# "high" (maxval 4095, quality 100), per route
NOISE_HIGH_SHA = {"mxu": "bafbf17ec8b0", "fused1": "12df8d46e37d"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def high(monkeypatch):
    monkeypatch.setenv("DMMT_P1_PREC", "high")
    return monkeypatch


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _plane(seed, h, w, scale=16):
    """float32 [h, w] level-shifted plane: integers / scale in [-128, 128)."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-128 * scale, 128 * scale, (h, w)) / scale).astype(np.float32)


def _column_operand(plane):
    """[H, W] plane -> [8, H / 8 * W]: the 8-row groups side by side, as the
    JAX reference's column pass takes them."""
    h, w = plane.shape
    return np.ascontiguousarray(plane.reshape(h // 8, 8, w).transpose(1, 0, 2).reshape(8, -1))


def _pixels(seed, shape, maxval):
    rng = np.random.default_rng(seed)
    dtype = np.uint8 if maxval <= 255 else np.uint16
    yy, xx = np.mgrid[0 : shape[0], 0 : shape[1]]
    base = (xx * maxval) // max(shape[1] - 1, 1) // 2 + (yy * maxval) // max(shape[0] - 1, 1) // 4
    noise = rng.integers(-(maxval // 10), maxval // 10 + 1, (*shape, 3))
    return np.clip(base[..., None] + noise, 0, maxval).astype(dtype)


def _noise():
    return np.random.default_rng(1).integers(0, 4096, (128, 192, 3)).astype(np.uint16)


@pytest.mark.parametrize("half", ["hi", "lo"])
def test_host_bf16_dot_sums_in_pair_order(half):
    """The host assumption behind every other test here: jitted XLA
    jnp.dot of bf16 [8, 8] @ [8, 768] (the DCT matrix's bf16 half and the
    column operand of a 64 x 96 plane) with a float32 result equals the
    port's float32 chain in PAIR_ORDER, bit for bit. Where this fails, the
    host's XLA CPU dot adds in another order (no AVX512-BF16, or another
    XLA), and the JAX reference's DMMT_P1_PREC=high bytes are not the
    ones the port reproduces."""
    x = _column_operand(_plane(0, 64, 96))
    hi, lo = split_bf16(_t(x))
    b = hi if half == "hi" else lo
    a = _t(DCT_SPLIT[0])
    want = jax.jit(lambda p, q: jnp.dot(p, q, preferred_element_type=jnp.float32))(
        jnp.asarray(a.numpy()).astype(jnp.bfloat16), jnp.asarray(b.numpy()).astype(jnp.bfloat16))
    got = dot_bf16_pairs(a, b)
    mismatches = int((np.asarray(want) != got.numpy()).sum())
    assert mismatches == 0, (
        f"{mismatches} of {got.numel()} sums differ: this host's XLA CPU bf16 dot does not add the "
        f"products in the order {PAIR_ORDER} (AVX512-BF16 VDPBF16PS), so DMMT_P1_PREC=high's JAX "
        "reference bits differ from the port's")


def test_split_bf16_and_dct_halves():
    """split_bf16 is the JAX reference's split (bf16 round to nearest even
    of the value, then of the exact residual); DCT_SPLIT is C's."""
    x = _plane(1, 16, 64, scale=4096) * np.float32(255 / 4095)
    for value, (hi, lo) in ((x, split_bf16(_t(x))), (DCT_MATRIX, DCT_SPLIT)):
        jhi = jnp.asarray(value).astype(jnp.bfloat16)
        jlo = (jnp.asarray(value) - jhi.astype(jnp.float32)).astype(jnp.bfloat16)
        np.testing.assert_array_equal(np.asarray(hi), np.asarray(jhi.astype(jnp.float32)))
        np.testing.assert_array_equal(np.asarray(lo), np.asarray(jlo.astype(jnp.float32)))


@pytest.mark.parametrize("shape", [(8, 8), (64, 96), (136, 200), (16, 1024)])
def test_dot_p1_matches_jax_both_passes(high, shape):
    """The port's dot_p1 against the JAX dot_p1 under "high", bit for bit:
    the column pass C [8, 8] @ [8, N] and the row pass [M, 8] @ C^T."""
    plane = _plane(sum(shape), *shape)
    c = DCT_MATRIX
    jdot = jax.jit(lambda p, q: jmxu.dot_p1(p, q))
    x = _column_operand(plane)
    np.testing.assert_array_equal(dot_p1(_t(c), _t(x)).numpy(),
                                  np.asarray(jdot(jnp.asarray(c), jnp.asarray(x))))
    t1 = plane.reshape(-1, 8) * np.float32(2.75)
    np.testing.assert_array_equal(dot_p1(_t(t1), _t(c.T)).numpy(),
                                  np.asarray(jdot(jnp.asarray(t1), jnp.asarray(c.T))))


@pytest.mark.parametrize("shape", [(8, 8), (24, 136), (8, 1928), (80, 72)])
def test_mxu_plain_high_matches_jax_reference(high, shape):
    """K9's plain version with split against the JAX mxu_dct_reference under
    "high", on the matmul plane DCT's edge inputs (saturated groups, DCs
    on x.5 after / q, a table past 8 bits on 80 x 72) and a plane of
    sixteenths."""
    jref = jax.jit(lambda p, q: jmxu.mxu_dct_reference(p, q))
    plane, q = plane_mm_edge_inputs(*shape)
    cases = [(plane, q), (_plane(shape[0] * 7 + shape[1], *shape), q)]
    for p, qt in cases:
        got = plane_dct_quant_mxu(_t(p), _t(qt.astype(np.int32)), split=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jref(jnp.asarray(p), jnp.asarray(qt))))


@pytest.mark.parametrize("preset,maxval,shape", [
    ("P420", 255, (37, 53)), ("P422", 4095, (37, 53)), ("P444", 65535, (37, 53)),
    ("P420", 65535, (9, 35)), ("P422", 255, (15, 16)), ("P444", 4095, (29, 41)),
])
def test_fused_phase1_plain_high_matches_jax_reference(high, preset, maxval, shape):
    """K10's plain version with split against the JAX fused_phase1_reference
    under "high" on odd geometries (the JAX function takes the planes
    padded to the MCU multiple)."""
    hr, vr = RATES[preset]
    h, w = shape
    px = _pixels(maxval + h + w, shape, maxval)
    p = ChromaSubsamplingPreset(preset)
    ph, pw = geometry.padded_size(h, w, p)
    planes = [jnp.pad(jnp.asarray(px[..., i]), ((0, ph - h), (0, pw - w))) for i in range(3)]
    lq, cq = quantization_table_pair(dt.QuantizationTablePreset.SPECIFICATION, 90)
    want = jax.jit(lambda r, g, b, m, l, c: jfused1.fused_phase1_reference(r, g, b, m, l, c, hr, vr))(
        *planes, jnp.float32(maxval), jnp.asarray(lq), jnp.asarray(cq))
    got = fused_phase1(_t(px), maxval, _t(lq), _t(cq), p, split=True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("mode", ["mxu", "fused1"])
def test_noise_image_bytes_match_jax(high, mode):
    """The noise image (maxval 4095, quality 100) under "high": the JAX
    package's bytes, which differ from the route's bytes under "highest"."""
    high.setenv("DMMT_P1", mode)
    px, cfg = _noise(), dj.EncoderConfig(quality=100)
    want = dj.encode_array(px, 4095, cfg)
    assert hashlib.sha256(want).hexdigest()[:12] == NOISE_HIGH_SHA[mode]
    port = config_from_jax(cfg)
    assert dt.encode_array(px, 4095, port, device="cpu") == want
    off = dataclasses.replace(port, one_dispatch="off")
    assert dt.encode_array(px, 4095, off, device="cpu") == want
    high.setenv("DMMT_P1_PREC", "highest")
    assert dt.encode_array(px, 4095, port, device="cpu") != want


@pytest.mark.parametrize("mode", ["mxu", "fused1"])
def test_entry_points_bytes_match_jax(high, mode):
    """Under "high", every entry point that reaches phase 1 gives the JAX
    package's encode_array bytes: encode_array one-dispatch and
    two-dispatch, encode_batch as the slab and with fused_batch=2,
    start_one_dispatch on planar input and start_one_dispatch_multi on a
    planar stack."""
    high.setenv("DMMT_P1", mode)
    frames = [_pixels(60 + i, (45, 71), 255) for i in range(3)]
    jcfg = dj.EncoderConfig(chroma_subsampling=dj.ChromaSubsamplingPreset.P420, quality=95)
    want = [dj.encode_array(px, 255, jcfg) for px in frames]
    cfg = config_from_jax(jcfg)
    assert [dt.encode_array(px, 255, cfg, device="cpu") for px in frames] == want
    off = dataclasses.replace(cfg, one_dispatch="off")
    assert dt.encode_array(frames[0], 255, off, device="cpu") == want[0]
    assert dt.encode_batch(frames, 255, cfg, device="cpu") == want
    assert dt.encode_batch(frames, 255, cfg, fused_batch=2, device="cpu") == want
    lq, cq = quantization_table_pair(cfg.quantization_preset, cfg.quality)
    planar = np.ascontiguousarray(np.stack(frames).transpose(0, 3, 1, 2))

    def jpegs(states):
        return [_jpeg((45, 71), cfg, lq, cq, *tod.finish_one_dispatch(s, cfg)) for s in states]

    assert jpegs([tod.start_one_dispatch(planar[1], 255, cfg, lq, cq, device="cpu")]) == want[1:2]
    assert jpegs(tod.start_one_dispatch_multi(planar, 255, cfg, lq, cq, device="cpu")) == want


@pytest.mark.parametrize("mode,preset", [("mxu", "P422"), ("fused1", "P444"), ("mxu", "P444"),
                                         ("fused1", "P422")])
def test_presets_and_maxval_bytes_match_jax(high, mode, preset):
    """P422 and P444 at maxval 65535 on an odd geometry."""
    high.setenv("DMMT_P1", mode)
    px = _pixels(7, (23, 33), 65535)
    jcfg = dj.EncoderConfig(chroma_subsampling=dj.ChromaSubsamplingPreset(preset))
    assert dt.encode_array(px, 65535, config_from_jax(jcfg), device="cpu") == dj.encode_array(
        px, 65535, jcfg)


@pytest.mark.parametrize("label,env,kw", [
    ("default route", {}, {}),
    ("DMMT_P1=pallas", {"DMMT_P1": "pallas"}, {}),
    ("SIMPLE", {}, {"dct_variant": dt.DCTVariant.SIMPLE}),
    ("SEPARATED", {}, {"dct_variant": dt.DCTVariant.SEPARATED}),
    ("FUSED", {}, {"dct_variant": dt.DCTVariant.FUSED}),
    ("SIMPLE under DMMT_P1=mxu", {"DMMT_P1": "mxu"}, {"dct_variant": dt.DCTVariant.SIMPLE}),
    ("two shards under DMMT_P1=mxu", {"DMMT_P1": "mxu"}, {"num_shards": 2}),
])
def test_paths_that_ignore_it_keep_their_bytes(monkeypatch, label, env, kw):
    """The paths that do not read DMMT_P1_PREC give their "highest" bytes
    under "high", on the noise image, where the mxu route's bytes under the
    two differ."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    px, cfg = _noise(), dt.EncoderConfig(quality=100, **kw)
    monkeypatch.setenv("DMMT_P1_PREC", "highest")
    want = dt.encode_array(px, 4095, cfg, device="cpu")
    monkeypatch.setenv("DMMT_P1_PREC", "high")
    assert dt.encode_array(px, 4095, cfg, device="cpu") == want


def test_check_p1_precision(monkeypatch):
    monkeypatch.delenv("DMMT_P1_PREC", raising=False)
    assert check_p1_precision() == "highest"
    for v in ("high", "highest"):
        monkeypatch.setenv("DMMT_P1_PREC", v)
        assert check_p1_precision() == v
    for v in ("medium", "HIGH", ""):
        monkeypatch.setenv("DMMT_P1_PREC", v)
        with pytest.raises(ValueError, match="DMMT_P1_PREC"):
            check_p1_precision()
