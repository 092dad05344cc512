"""PyTorch port, the bytes of the multi-device encode
(parallel/sharding.py): encode_array, encode_batch and the CLI with
num_shards 2 and 8 against the JAX package's encode_array on the CPU,
exactly.

On the CPU `kernels_capable` is False, so the sharded encode takes the
paths the JAX package takes without Pallas: masked histograms, two
dispatches, the staged pack. The `capable` fixture makes it True, as the
JAX suite sets DMMT_PALLAS_INTERPRET=1, so that the one-dispatch encode,
the block-histogram route with valid counts, the scan-pack kernel's arm
and the sharded slab run here too, with the kernels' plain versions.
Guards count the calls, since equal bytes alone cannot show which path
ran. Several shards on the CPU stand in for several devices, as the JAX
suite's virtual 8-device CPU mesh does."""

import dataclasses

import numpy as np
import pytest

import dmmt_jpeg_encoder_tpu as dj
import dmmt_jpeg_encoder_tpu_torch as dt
from dmmt_jpeg_encoder_tpu import cli as jax_cli
from dmmt_jpeg_encoder_tpu.io.ppm import write_ppm
from dmmt_jpeg_encoder_tpu_torch import cli as port_cli
from dmmt_jpeg_encoder_tpu_torch import encoder as tenc
from dmmt_jpeg_encoder_tpu_torch.config import config_from_jax
from dmmt_jpeg_encoder_tpu_torch.parallel import sharding as tshard
from dmmt_jpeg_encoder_tpu_torch.utils import capability

_JAX_CACHE: dict = {}


def _image(seed, shape, maxval=255):
    rng = np.random.default_rng(seed)
    px = rng.integers(0, maxval + 1, (*shape, 3))
    return px.astype(np.uint8 if maxval <= 255 else np.uint16)


def _cfg(preset="P420", n=1, **kw):
    return dj.EncoderConfig(chroma_subsampling=dj.ChromaSubsamplingPreset(preset), num_shards=n, **kw)


def _want(px, cfg, maxval=255):
    """The JAX package's encode_array (cached by content and config)."""
    key = (px.tobytes(), px.shape, maxval, cfg)
    if key not in _JAX_CACHE:
        _JAX_CACHE[key] = dj.encode_array(px, maxval, cfg)
    return _JAX_CACHE[key]


def _port(px, cfg, maxval=255, **kw):
    return dt.encode_array(px, maxval, config_from_jax(cfg), device="cpu", **kw)


@pytest.fixture
def capable(monkeypatch):
    """The devices run the kernels (on the CPU: their plain versions)."""
    monkeypatch.setattr(capability, "kernels_capable", lambda device: True)


@pytest.fixture
def calls(monkeypatch):
    """Count the sharded encode's calls of each histogram and pack route."""
    counts = {}
    for name in ("fused_block_histograms", "symbol_histograms", "fused_pack_words",
                 "fused_pack_words_slab", "staged_pack_words", "device_tables"):
        real = getattr(tshard, name)
        counts[name] = 0

        def counted(*a, _real=real, _name=name, **k):
            counts[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(tshard, name, counted)
    return counts


# --- bytes -----------------------------------------------------------------------------

GEOMETRIES = [("P420", (3 * 16, 24)), ("P422", (100, 30)), ("P444", (8 * 8, 40)),
              ("P420", (123, 205))]


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("preset,shape", GEOMETRIES)
def test_encode_array_sharded_matches_jax(preset, shape, n, calls):
    """The CPU's own route (two dispatches, masked histograms, the staged
    pack) and the host scan backend (C and Python packers)."""
    px = _image(11, shape)
    want = _want(px, _cfg(preset))
    assert _port(px, _cfg(preset, n)) == want
    assert calls["staged_pack_words"] == n and calls["fused_pack_words"] == 0
    assert calls["symbol_histograms"] == 2 * n and calls["fused_block_histograms"] == 0
    host = _cfg(preset, n, scan_backend="host")
    assert _port(px, host) == want
    assert _port(px, host, use_native=False) == want
    assert calls["device_tables"] == 0


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("preset,shape", GEOMETRIES)
def test_encode_array_sharded_kernel_routes_match_jax(preset, shape, n, capable, calls,
                                                      monkeypatch):
    """Where the devices run the kernels: one dispatch (block histograms
    with valid counts, one table build, a masked scan pack per shard),
    one_dispatch="off" (not read on the sharded path, as in the JAX
    package: one dispatch again), DMMT_NO_FUSED_PACK (the staged arm) and
    DMMT_HIST=pallas (masked weighted histograms)."""
    px = _image(12, shape)
    want = _want(px, _cfg(preset))
    assert _port(px, _cfg(preset, n)) == want
    assert calls == {"fused_block_histograms": 3 * n, "symbol_histograms": 0,
                     "fused_pack_words": n, "fused_pack_words_slab": 0, "staged_pack_words": 0,
                     "device_tables": 1}
    assert _port(px, _cfg(preset, n, one_dispatch="off")) == want
    assert calls == {"fused_block_histograms": 6 * n, "symbol_histograms": 0,
                     "fused_pack_words": 2 * n, "fused_pack_words_slab": 0, "staged_pack_words": 0,
                     "device_tables": 2}
    monkeypatch.setenv("DMMT_NO_FUSED_PACK", "1")
    assert _port(px, _cfg(preset, n)) == want
    assert calls["staged_pack_words"] == n and calls["device_tables"] == 2
    monkeypatch.delenv("DMMT_NO_FUSED_PACK")
    monkeypatch.setenv("DMMT_HIST", "pallas")
    assert _port(px, _cfg(preset, n)) == want
    assert calls["symbol_histograms"] == 2 * n and calls["device_tables"] == 3


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("one_dispatch", ["auto", "off"])
def test_sharded_images_past_the_table_bound_take_the_scan_pack_arm(n, one_dispatch, capable,
                                                                    calls, monkeypatch):
    """An image past the device table build's bound (a small
    MAX_DEVICE_TABLE_SYMBOLS) takes the sharded two-dispatch encode with
    the scan-pack kernel per shard, as the JAX package reaches
    _compiled_shard_pack there, whatever one_dispatch says."""
    from dmmt_jpeg_encoder_tpu_torch import onedispatch as tod

    monkeypatch.setattr(tod, "MAX_DEVICE_TABLE_SYMBOLS", 64 * 10)
    px = _image(13, (40, 56))
    assert _port(px, _cfg("P420", n, one_dispatch=one_dispatch)) == _want(px, _cfg("P420"))
    assert calls == {"fused_block_histograms": 3 * n, "symbol_histograms": 0,
                     "fused_pack_words": n, "fused_pack_words_slab": 0, "staged_pack_words": 0,
                     "device_tables": 0}


@pytest.mark.parametrize("route", ["p1_mxu", "p1_fused1", "simple", "separated", "fused"])
def test_sharded_phase1_follows_the_jax_package(route, monkeypatch):
    """The JAX package's sharded phase 1 ignores DMMT_P1 and calls dct2d,
    which computes the Arai DCT for FUSED: on a noise image where those
    routes change the single-device bytes, the sharded bytes are the JAX
    package's sharded bytes (ARAI's, but for SIMPLE and SEPARATED)."""
    px = np.random.default_rng(1).integers(0, 4096, (128, 192, 3)).astype(np.uint16)
    arai = _want(px, dj.EncoderConfig(quality=100), 4095)
    variant = route if route in ("simple", "separated", "fused") else "arai"
    if route.startswith("p1_"):
        monkeypatch.setenv("DMMT_P1", route[3:])
    cfg = dj.EncoderConfig(quality=100, dct_variant=dj.DCTVariant(variant))
    single = dj.encode_array(px, 4095, cfg)
    want = dj.encode_array(px, 4095, dataclasses.replace(cfg, num_shards=2))
    assert single != arai
    assert want == (single if route in ("simple", "separated") else arai)
    assert _port(px, dataclasses.replace(cfg, num_shards=2), 4095) == want


def test_encode_batch_sharded_matches_jax(capable, calls, monkeypatch):
    """The sharded slab (one table build per group; B scan-pack calls per
    shard, or one slab call per shard with DMMT_SLAB_ONEPACK=1), a
    trailing single image, DMMT_SLAB=0, the host backend, and fused_batch
    ignored."""
    frames = [_image(20 + i, (45, 71)) for i in range(5)]
    want = [_want(px, _cfg("P422", quality=90)) for px in frames]
    cfg = config_from_jax(_cfg("P422", 2, quality=90))
    monkeypatch.setenv("DMMT_SLAB_B", "4")
    assert tenc.slab_depth(frames, cfg, ["cpu"] * 2) == 4
    assert dt.encode_batch(frames, 255, cfg, device="cpu") == want
    assert calls["device_tables"] == 2 and calls["fused_pack_words"] == 2 * 4 + 2
    monkeypatch.setenv("DMMT_SLAB_ONEPACK", "1")
    assert dt.encode_batch(frames, 255, cfg, fused_batch=4, device="cpu") == want
    assert calls["device_tables"] == 4 and calls["fused_pack_words_slab"] == 2
    monkeypatch.setenv("DMMT_SLAB", "0")
    assert dt.encode_batch(frames, 255, cfg, device=["cpu", "cpu"]) == want
    assert calls["device_tables"] == 9 and calls["fused_pack_words_slab"] == 2
    host = dataclasses.replace(cfg, scan_backend="host")
    assert dt.encode_batch(frames[:2], 255, host, device="cpu") == want[:2]
    assert calls["device_tables"] == 9


def test_encode_batch_sharded_two_dispatch_on_the_cpu(calls):
    frames = [_image(30 + i, (33, 50)) for i in range(3)]
    want = [_want(px, _cfg("P420")) for px in frames]
    assert dt.encode_batch(frames, 255, config_from_jax(_cfg("P420", 8)), device="cpu") == want
    assert calls["device_tables"] == 0 and calls["staged_pack_words"] == 3 * 8


@pytest.mark.parametrize("device", ["cpu", "cpu,cpu"])
def test_cli_shards_matches_jax_cli(tmp_path, device):
    src = tmp_path / "in.ppm"
    write_ppm(src, _image(9, (70, 44)))
    a, b = tmp_path / "jax.jpg", tmp_path / "port.jpg"
    flags = ["-p", "P422", "--shards", "2"]
    assert jax_cli.main([str(src), str(a), *flags]) == 0
    assert port_cli.main([str(src), str(b), *flags, "--device", device]) == 0
    assert b.read_bytes() == a.read_bytes()
    assert port_cli.main([str(src), str(b), "--shards", "3", "--device", "cpu,cpu"]) == 1

