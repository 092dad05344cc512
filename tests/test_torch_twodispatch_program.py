"""PyTorch port, the two-dispatch programs: the seven caches of captured
two-dispatch halves (pipeline._compiled_pipeline and
_compiled_pipeline_batch; bitstream/device_pack._compiled_fused_pack,
_compiled_pack and _compiled_pack_batch; parallel/sharding._compiled_sharded
and _compiled_shard_pack) against the JAX package's names and bounds, what
a toggled mode and the staged pack's word bucket do to their keys, the
lease of a first half's result, and the bytes of every two-dispatch path on
the CPU and on the card path, against the JAX package's encode_array.

A CUDA graph is captured only on a card (chip_smoke.py checks the
replays). Here, as in test_torch_onedispatch_program.py,
`programs.Program` is replaced by FakeProgram, which fills its inputs,
counts one replay of its kind and runs the eager enqueue on the CPU, and
`programs.target` names a card, so the card route (keys, caches, pools, leases, one replay
per program) runs as it does on a card, graph aside. The tolerance is
zero: bytes must be identical."""

import dataclasses
import gc

import numpy as np
import pytest

import dmmt_jpeg_encoder_tpu as dj
import dmmt_jpeg_encoder_tpu_torch as dt
from dmmt_jpeg_encoder_tpu import pipeline as jpipe
from dmmt_jpeg_encoder_tpu.bitstream import device_pack as jpack
from dmmt_jpeg_encoder_tpu.parallel import sharding as jshard
from dmmt_jpeg_encoder_tpu_torch import encoder as tenc
from dmmt_jpeg_encoder_tpu_torch import onedispatch as tod
from dmmt_jpeg_encoder_tpu_torch import pipeline as tpipe
from dmmt_jpeg_encoder_tpu_torch import programs
from dmmt_jpeg_encoder_tpu_torch.bitstream import device_pack as tpack
from dmmt_jpeg_encoder_tpu_torch.config import ChromaSubsamplingPreset, DCTVariant, config_from_jax
from dmmt_jpeg_encoder_tpu_torch.kernels import build
from dmmt_jpeg_encoder_tpu_torch.parallel import sharding as tshard
from dmmt_jpeg_encoder_tpu_torch.tables import quantization_table_pair
from dmmt_jpeg_encoder_tpu_torch.utils import capability
from test_torch_onedispatch_program import CARD, FakeProgram
from test_torch_program_refinish import PROGRAM_CACHES
from torch_port_fixtures import fixture_pixels

P420 = ChromaSubsamplingPreset.P420
# cache -> (port module, JAX module, the JAX package's maxsize)
CACHES = {
    "_compiled_pipeline": (tpipe, jpipe, 32),
    "_compiled_pipeline_batch": (tpipe, jpipe, 16),
    "_compiled_fused_pack": (tpack, jpack, 64),
    "_compiled_pack": (tpack, jpack, 32),
    "_compiled_pack_batch": (tpack, jpack, 16),
    "_compiled_sharded": (tshard, jshard, 16),
    "_compiled_shard_pack": (tshard, jshard, 16),
}
_JAX_BYTES: dict = {}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("DMMT_P1", "DMMT_P1_PREC", "DMMT_HIST", "DMMT_NO_FUSED_PACK", "DMMT_SLAB_ONEPACK",
              "DMMT_NO_ONEDISPATCH"):
        monkeypatch.delenv(k, raising=False)
    build.reset_launch_counts()
    yield
    for module, name in PROGRAM_CACHES:
        getattr(module, name).cache_clear()
    gc.collect()


@pytest.fixture
def card_path(monkeypatch):
    """Every two-dispatch half takes its card path, with FakeProgram; the
    devices run the kernels (their plain versions here)."""
    monkeypatch.setattr(FakeProgram, "count", 0)
    monkeypatch.setattr(programs, "Program", FakeProgram)
    monkeypatch.setattr(programs, "target", lambda pixels, device: CARD)
    monkeypatch.setattr(capability, "kernels_capable", lambda device: True)
    return FakeProgram


def _image(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, (*shape, 3)).astype(np.uint8)


IMAGES = {"7x17_p444": lambda: fixture_pixels("7x17_p444"), "8x8_p420": lambda: _image(80, (8, 8))}
PRESETS = {"7x17_p444": "P444", "8x8_p420": "P420"}


def _jax_cfg(preset, **kw):
    return dj.EncoderConfig(chroma_subsampling=dj.ChromaSubsamplingPreset(preset), **kw)


def _want(px, preset):
    """The JAX package's encode_array (its CPU two-dispatch path), cached."""
    key = (px.tobytes(), px.shape, preset)
    if key not in _JAX_BYTES:
        _JAX_BYTES[key] = dj.encode_array(px, 255, _jax_cfg(preset))
    return _JAX_BYTES[key]


def _replays():
    return {k: v for k, v in build.replay_counts().items() if v}


def _maxsize(fn):
    return fn.cache_clear.__self__.cache_parameters()["maxsize"]


@pytest.mark.parametrize("name", sorted(CACHES))
def test_cache_bounds_equal_the_jax_packages(name):
    port, jax_module, maxsize = CACHES[name]
    assert _maxsize(getattr(port, name)) == _maxsize(getattr(jax_module, name)) == maxsize


def _cache_args(name):
    """Arguments of each cache for a 16x16 P420 image of two shards."""
    lq, cq = quantization_table_pair(dt.EncoderConfig().quantization_preset, None)
    key = programs.program_key(np.zeros((16, 16, 3), np.uint8), 255, lq, cq, CARD)
    return {
        "_compiled_pipeline": (16, 16, P420, DCTVariant.ARAI, *key),
        "_compiled_pipeline_batch": (2, 16, 16, P420, DCTVariant.ARAI, False, *key),
        "_compiled_fused_pack": (4, 1, 4, 6 * 64 + 2, CARD),
        "_compiled_pack": (4, 1, 4, 4096, CARD),
        "_compiled_pack_batch": (2, 4, 1, 4, 4096, CARD),
        "_compiled_sharded": (16, 16, P420, DCTVariant.ARAI, 2, *key),
        "_compiled_shard_pack": (2, 2, 1, 4, 4096, 1, 1, 1, True, CARD),
    }[name]


@pytest.mark.parametrize("knob,value", [("DMMT_P1", "fused1"), ("DMMT_HIST", "pallas")])
@pytest.mark.parametrize("name", sorted(CACHES))
def test_mode_toggled_after_capture_gives_new_entry(monkeypatch, name, knob, value):
    cache = getattr(CACHES[name][0], name)
    args = _cache_args(name)
    first = cache(*args)
    assert cache(*args) is first
    monkeypatch.setenv(knob, value)
    toggled = cache(*args)
    assert toggled is not first and cache(*args) is toggled
    assert cache.cache_info().currsize == 2
    monkeypatch.delenv(knob)
    assert cache(*args) is first


def test_staged_pack_shares_one_program_within_a_bucket(card_path, monkeypatch):
    """Two images whose streams need different word counts inside one
    power-of-two bucket (the JAX package's, `1 << max(12, bit_length)`)
    pack with one program of one key, each to the JAX package's bytes."""
    monkeypatch.setenv("DMMT_NO_FUSED_PACK", "1")
    cfg = dt.EncoderConfig(one_dispatch="off")
    lq, cq = quantization_table_pair(cfg.quantization_preset, cfg.quality)
    needed = []
    for px in (_image(81, (16, 16)), np.zeros((16, 16, 3), np.uint8)):
        result = tpipe.run_device_pipeline(px, 255, cfg, lq, cq)
        tables = tenc.HuffmanTables.from_histograms(result)
        hists = (result.luma_dc_hist, result.luma_ac_hist, result.chroma_dc_hist,
                 result.chroma_ac_hist)
        needed.append((tpack.exact_scan_bits(hists, *tables.flat()) + 31) // 32 + 2)
        scan = tenc.pack_scan(result, tables, cfg)
        assert tenc._jpeg(px.shape, cfg, lq, cq, scan, tables) == _want(px, "P420")
    assert needed[0] != needed[1]
    assert tpack.words_capacity(needed[0]) == tpack.words_capacity(needed[1]) == 4096
    assert tpack._compiled_pack.cache_info().currsize == 1
    assert [len(p.idle) for p in programs.POOLS if p.idle and p.idle[0].kind == "pack"] == [1]
    assert (tpack.words_capacity(4095), tpack.words_capacity(4096)) == (4096, 8192)


def _paths(preset):
    """label -> (environment, port config, replays per card call)."""
    off = config_from_jax(_jax_cfg(preset, one_dispatch="off"))
    return {
        "fused pack": ({}, off, {"pipeline": 1, "fused_pack": 1}),
        "staged pack": ({"DMMT_NO_FUSED_PACK": "1"}, off, {"pipeline": 1, "pack": 1}),
        "DMMT_HIST=pallas": ({"DMMT_HIST": "pallas"}, off, {"pipeline": 1, "fused_pack": 1}),
        "host backend": ({}, dataclasses.replace(off, scan_backend="host"), {"pipeline": 1}),
        "DMMT_NO_ONEDISPATCH": ({"DMMT_NO_ONEDISPATCH": "1"},
                                config_from_jax(_jax_cfg(preset)), {"pipeline": 1, "fused_pack": 1}),
    }


@pytest.mark.parametrize("path", ["cpu", "card"])
@pytest.mark.parametrize("name", sorted(IMAGES))
def test_two_dispatch_bytes_match_jax(request, monkeypatch, path, name):
    """encode_array's two-dispatch paths: each JPEG equals the JAX
    package's; on the card path each call is exactly one replay of each
    of its programs, on the CPU none."""
    if path == "card":
        request.getfixturevalue("card_path")
    px, preset = IMAGES[name](), PRESETS[name]
    want = _want(px, preset)
    for label, (env, cfg, replays) in _paths(preset).items():
        with monkeypatch.context() as m:
            for k, v in env.items():
                m.setenv(k, v)
            for _ in range(2):
                build.reset_launch_counts()
                assert dt.encode_array(px, 255, cfg, device="cpu") == want, label
                assert _replays() == (replays if path == "card" else {}), label


@pytest.mark.parametrize("path", ["cpu", "card"])
def test_fused_batch_bytes_match_jax(request, path):
    """encode_batch(fused_batch=2) of three same-shape images: one chunk of
    two (one replay of each batch program on the card path) and one
    single image (encode_array, one-dispatch)."""
    if path == "card":
        request.getfixturevalue("card_path")
    frames = [_image(82 + i, (20, 36)) for i in range(3)]
    want = [_want(px, "P420") for px in frames]
    assert dt.encode_batch(frames, 255, dt.EncoderConfig(), fused_batch=2, device="cpu") == want
    assert _replays() == ({"pipeline_batch": 1, "pack_batch": 1, "onedispatch": 1}
                          if path == "card" else {})


@pytest.mark.parametrize("pack", ["fused", "staged", "host"])
@pytest.mark.parametrize("path", ["cpu", "card", "distinct"])
def test_sharded_two_dispatch_bytes_match_jax(request, monkeypatch, path, pack):
    """The sharded two-dispatch encode at 2 shards, past a device table
    bound lowered to one symbol: one replay of _compiled_sharded and one
    of _compiled_shard_pack per encode on one card (the host backend: the
    first only); the CPU and two distinct devices ("cpu", "cpu:0") stay op
    by op. Each JPEG equals the JAX package's."""
    monkeypatch.setattr(capability, "kernels_capable", lambda device: True)
    if path != "cpu":
        request.getfixturevalue("card_path")
    monkeypatch.setattr(tod, "MAX_DEVICE_TABLE_SYMBOLS", 1)
    if pack == "staged":
        monkeypatch.setenv("DMMT_NO_FUSED_PACK", "1")
    px = _image(85, (20, 36))
    cfg = dt.EncoderConfig(num_shards=2, scan_backend="host" if pack == "host" else "auto")
    devices = ["cpu", "cpu:0"] if path == "distinct" else ["cpu"] * 2
    assert dt.encode_array(px, 255, cfg, device=devices) == _want(px, "P420")
    expected = {"sharded": 1} if pack == "host" else {"sharded": 1, "shard_pack": 1}
    assert _replays() == (expected if path == "card" else {})


def test_pipeline_result_holds_its_instance_until_collected(card_path):
    """A first half's result leases its instance until it is collected;
    a second result in flight takes another; the batch form's seven tensors
    hold theirs until the last is collected."""
    cfg = dt.EncoderConfig(one_dispatch="off")
    lq, cq = quantization_table_pair(cfg.quantization_preset, cfg.quality)
    px = _image(86, (16, 16))
    first = tpipe.run_device_pipeline(px, 255, cfg, lq, cq)
    pool = tpipe._compiled_pipeline(16, 16, P420, DCTVariant.ARAI,
                                    *programs.program_key(px, 255, lq, cq, CARD))
    second = tpipe.run_device_pipeline(px, 255, cfg, lq, cq)
    assert card_path.count == 2 and pool.idle == []
    del first
    gc.collect()
    assert len(pool.idle) == 1
    del second
    gc.collect()
    assert len(pool.idle) == 2
    outputs = list(tpipe.run_device_pipeline_batch(np.stack([px, px]), 255, cfg, lq, cq))
    batch_pool = tpipe._compiled_pipeline_batch(2, 16, 16, P420, DCTVariant.ARAI, False,
                                                *programs.program_key(px, 255, lq, cq, CARD))
    while outputs:
        assert batch_pool.idle == []
        outputs.pop()
        gc.collect()
    assert len(batch_pool.idle) == 1


def test_failed_capture_raises_without_fallback(card_path, monkeypatch):
    """A program that cannot be captured fails the call: the card path never
    falls back to the eager enqueue."""
    eager = []
    real = tpipe.device_phase
    monkeypatch.setattr(tpipe, "device_phase", lambda *a, **k: eager.append(1) or real(*a, **k))

    def broken(*args, **kwargs):
        raise RuntimeError("capture failed")

    monkeypatch.setattr(programs, "Program", broken)
    px = _image(87, (16, 16))
    with pytest.raises(RuntimeError, match="capture failed"):
        dt.encode_array(px, 255, dt.EncoderConfig(one_dispatch="off"), device="cpu")
    assert eager == []
