"""PyTorch port, the sharded one-dispatch programs (parallel/sharding.py):
the two program caches' names and bounds against the JAX package's, what
their key separates, the lease of a captured instance, the routing of a
device list (one card: a replay; several distinct devices: the op-by-op
enqueue), the histogram state a program passes down, and the bytes of
encode_array and encode_batch at 2 and 8 shards against the JAX
package's encode_array on the CPU.

A CUDA graph is captured only on a card (chip_smoke.py checks the
replays). Here, as in test_torch_onedispatch_program.py,
`programs.Program` is replaced by FakeProgram, which runs the eager
enqueue on the CPU, and `programs.target` names a card, so the card route (keys, caches,
pools, leases) runs as it does on a card, graph aside; `capable` makes
the CPU run the kernel routes' plain versions. The tolerance is zero:
bytes must be identical."""

import gc

import numpy as np
import pytest
import torch

import dmmt_jpeg_encoder_tpu_torch as dt
from dmmt_jpeg_encoder_tpu.parallel import sharding as jshard
from dmmt_jpeg_encoder_tpu_torch import encoder as tenc
from dmmt_jpeg_encoder_tpu_torch import programs
from dmmt_jpeg_encoder_tpu_torch.config import ChromaSubsamplingPreset, DCTVariant, config_from_jax
from dmmt_jpeg_encoder_tpu_torch.parallel import sharding as tshard
from dmmt_jpeg_encoder_tpu_torch.tables import quantization_table_pair
from test_torch_onedispatch_program import CARD, FakeProgram, card_path  # noqa: F401 (fixture)
from test_torch_sharded_encode import _cfg, _image, _want, capable  # noqa: F401 (fixture)

CACHES = ("_compiled_sharded_onedispatch", "_compiled_sharded_onedispatch_slab")
KNOBS = {"DMMT_HIST": "pallas", "DMMT_SLAB_ONEPACK": "1"}
P420 = ChromaSubsamplingPreset.P420


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("DMMT_P1", "DMMT_P1_PREC", "DMMT_NO_FUSED_PACK", "DMMT_SLAB", "DMMT_SLAB_B", *KNOBS):
        monkeypatch.delenv(k, raising=False)
    yield
    for name in CACHES:
        getattr(tshard, name).cache_clear()
    gc.collect()


@pytest.fixture
def routes(monkeypatch):
    """Count the eager starts (`_start`) and the replays (`_replay`)."""
    counts = {"_start": 0, "_replay": 0}
    for name in counts:
        real = getattr(tshard, name)

        def counted(*a, _real=real, _name=name, **k):
            counts[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(tshard, name, counted)
    return counts


def _tables(cfg=None):
    cfg = cfg or dt.EncoderConfig()
    return quantization_table_pair(cfg.quantization_preset, cfg.quality)


def _cache_args(n_images=None, height=16, width=16, preset=P420, variant=DCTVariant.ARAI,
                num_shards=2, pixels=None, maxval=255, tables=None):
    pixels = np.zeros((16, 16, 3), np.uint8) if pixels is None else pixels
    head = () if n_images is None else (n_images,)
    return (*head, height, width, preset, variant, num_shards,
            *programs.program_key(pixels, maxval, *(tables or _tables()), CARD))


def _pool(px, cfg, n_images=None):
    """The pool a sharded start's card route leases from for `px` (a slab
    of n_images when given)."""
    args = _cache_args(n_images, *px.shape[:2], cfg.chroma_subsampling, cfg.dct_variant,
                       cfg.num_shards, px, 255, _tables(cfg))
    cache = tshard._compiled_sharded_onedispatch if n_images is None \
        else tshard._compiled_sharded_onedispatch_slab
    return cache(*args)


def _finish_jpegs(state, cfg, shape):
    lq, cq = _tables(cfg)
    done = tshard.finish_sharded_encode_slab(state, cfg) if state.n_images > 1 \
        else [tshard.finish_sharded_encode(state, cfg)]
    return [tenc._jpeg(shape, cfg, lq, cq, scan, tables) for scan, tables in done]


@pytest.mark.parametrize("name", CACHES)
def test_cache_bounds_equal_the_jax_packages(name):
    def maxsize(fn):
        return fn.cache_clear.__self__.cache_parameters()["maxsize"]

    assert maxsize(getattr(tshard, name)) == maxsize(getattr(jshard, name)) == {
        "_compiled_sharded_onedispatch": 16, "_compiled_sharded_onedispatch_slab": 8}[name]


@pytest.mark.parametrize("name", CACHES)
@pytest.mark.parametrize("change", [
    dict(height=24), dict(width=40), dict(preset=ChromaSubsamplingPreset.P422),
    dict(variant=DCTVariant.SIMPLE), dict(num_shards=4),
    dict(pixels=torch.zeros((16, 16, 3), dtype=torch.int16)), dict(maxval=254),
    dict(tables=_tables(dt.EncoderConfig(quality=75))),
], ids=["height", "width", "preset", "variant", "num_shards", "dtype", "maxval", "quant_tables"])
def test_program_key_separates(name, change):
    cache = getattr(tshard, name)
    n = None if name == CACHES[0] else 2
    base = cache(*_cache_args(n))
    assert cache(*_cache_args(n, **change)) is not base
    assert cache(*_cache_args(n)) is base


def test_program_key_separates_n_images():
    cache = tshard._compiled_sharded_onedispatch_slab
    assert cache(*_cache_args(2)) is not cache(*_cache_args(3))
    assert cache(*_cache_args(2)) is cache(*_cache_args(2))


@pytest.mark.parametrize("name", CACHES)
@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_knob_toggled_after_build_gives_new_entry(monkeypatch, name, knob):
    cache = getattr(tshard, name)
    args = _cache_args(None if name == CACHES[0] else 2)
    first = cache(*args)
    monkeypatch.setenv(knob, KNOBS[knob])
    toggled = cache(*args)
    assert toggled is not first and cache(*args) is toggled
    assert cache.cache_info().currsize == 2
    monkeypatch.delenv(knob)
    assert cache(*args) is first


@pytest.mark.parametrize("release", ["finish", "collect"])
def test_lease_held_until_finish_or_collection(capable, card_path, routes, release):
    px = _image(50, (40, 56))
    cfg = config_from_jax(_cfg("P420", 2))
    state = tshard.start_sharded_encode(px, 255, cfg, ["cpu"] * 2)
    pool = _pool(px, cfg)
    assert routes == {"_start": 0, "_replay": 1}
    assert card_path.count == 1 and pool.idle == []
    if release == "finish":
        assert _finish_jpegs(state, cfg, px.shape) == [_want(px, _cfg("P420"))]
    else:
        del state
        gc.collect()
    assert len(pool.idle) == 1
    # the next start leases the same instance
    tshard.finish_sharded_encode(tshard.start_sharded_encode(px, 255, cfg, ["cpu"] * 2), cfg)
    assert card_path.count == 1 and len(pool.idle) == 1


def test_two_starts_in_flight_build_two_instances(capable, card_path):
    frames = [_image(51 + i, (40, 56)) for i in range(2)]
    cfg = config_from_jax(_cfg("P420", 2))
    states = [tshard.start_sharded_encode(px, 255, cfg, ["cpu"] * 2) for px in frames]
    assert card_path.count == 2
    got = [_finish_jpegs(s, cfg, frames[0].shape)[0] for s in states[::-1]][::-1]
    assert got == [_want(px, _cfg("P420")) for px in frames]
    assert len(_pool(frames[0], cfg).idle) == 2
    again = [tshard.start_sharded_encode(px, 255, cfg, ["cpu"] * 2) for px in frames]
    assert card_path.count == 2
    assert [_finish_jpegs(s, cfg, frames[0].shape)[0] for s in again] == got


def test_slab_start_holds_one_lease(capable, card_path, routes):
    frames = [_image(53 + i, (40, 56)) for i in range(3)]
    cfg = config_from_jax(_cfg("P420", 2))
    state = tshard.start_sharded_encode_slab(frames, 255, cfg, ["cpu"] * 2)
    pool = _pool(frames[0], cfg, 3)
    assert isinstance(state, tshard.ShardedState) and state.n_images == 3
    assert routes == {"_start": 0, "_replay": 1}
    assert card_path.count == 1 and pool.idle == []
    assert _finish_jpegs(state, cfg, frames[0].shape) == [_want(px, _cfg("P420")) for px in frames]
    assert len(pool.idle) == 1


def test_slab_onepack_toggled_after_capture_gives_new_instance(capable, card_path, monkeypatch):
    frames = [_image(56 + i, (40, 56)) for i in range(2)]
    cfg = config_from_jax(_cfg("P420", 2))
    want = [_want(px, _cfg("P420")) for px in frames]
    for onepack, count in (("0", 1), ("1", 2), ("0", 2)):
        monkeypatch.setenv("DMMT_SLAB_ONEPACK", onepack)
        state = tshard.start_sharded_encode_slab(frames, 255, cfg, ["cpu"] * 2)
        assert _finish_jpegs(state, cfg, frames[0].shape) == want
        assert card_path.count == count
    assert tshard._compiled_sharded_onedispatch_slab.cache_info().currsize == 2


def test_distinct_devices_take_the_eager_route(capable, card_path, routes):
    """Two distinct devices (here "cpu" and "cpu:0" stand in for two cards)
    keep the op-by-op enqueue, even where one card would replay."""
    px = _image(58, (40, 56))
    frames = [px, px[::-1].copy()]
    cfg = config_from_jax(_cfg("P420", 2))
    devices = ["cpu", "cpu:0"]
    state = tshard.start_sharded_encode(px, 255, cfg, devices)
    assert state.release is None
    assert _finish_jpegs(state, cfg, px.shape) == [_want(px, _cfg("P420"))]
    slab = tshard.start_sharded_encode_slab(frames, 255, cfg, devices)
    assert _finish_jpegs(slab, cfg, px.shape) == [_want(f, _cfg("P420")) for f in frames]
    assert routes == {"_start": 2, "_replay": 0} and card_path.count == 0
    tshard.finish_sharded_encode(tshard.start_sharded_encode(px, 255, cfg, ["cpu"] * 2), cfg)
    assert routes == {"_start": 2, "_replay": 1} and card_path.count == 1


@pytest.mark.parametrize("hist,calls", [("fused", "fused_block_histograms"),
                                        ("pallas", "symbol_histograms")])
def test_enqueue_passes_its_histogram_state_to_every_call(monkeypatch, capable, hist, calls):
    """A captured program's K2/K5 state reaches each histogram call of
    every shard (3 block-histogram calls per shard, or 2 masked ones)."""
    monkeypatch.setenv("DMMT_HIST", hist)
    seen = []
    real = getattr(tshard, calls)

    def spy(*a, state=None, **k):
        seen.append(state)
        return real(*a, state=state, **k)

    monkeypatch.setattr(tshard, calls, spy)
    px = _image(59, (40, 56))
    cfg = config_from_jax(_cfg("P420", 4))
    geom = tshard.Geometry.of(40, 56, P420, 4)
    x = torch.zeros((geom.ph, geom.pw, 3), dtype=torch.uint8)
    x[:40, :56] = torch.from_numpy(px)
    mine = torch.zeros(4, dtype=torch.int32)
    state = tshard._enqueue(tshard.shard_slabs(x, geom), 1, 255, cfg, *_tables(), geom,
                            [x.device] * 4, True, hist_state=mine)
    assert len(seen) == (3 if hist == "fused" else 2) * 4
    assert all(s is mine for s in seen)
    tshard._prefetch(state)
    lq, cq = _tables()
    assert tenc._jpeg(px.shape, cfg, lq, cq, *tshard.finish_sharded_encode(state, cfg)) \
        == _want(px, _cfg("P420"))


BYTE_CASES = [("P420", (7, 17)), ("P444", (7, 17)), ("P422", (333, 1001))]


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("preset,shape", BYTE_CASES)
@pytest.mark.parametrize("path", ["cpu", "card"])
def test_sharded_bytes_match_jax(request, monkeypatch, capable, routes, path, preset, shape, n):
    """encode_array, and encode_batch as one slab group of two and a
    trailing single image, on the CPU's eager enqueue and on the card
    route's programs (FakeProgram): each JPEG equals the JAX package's."""
    if path == "card":
        request.getfixturevalue("card_path")
    frames = [_image(60 + i, shape) for i in range(3)]
    want = [_want(px, _cfg(preset)) for px in frames]
    cfg = config_from_jax(_cfg(preset, n))
    monkeypatch.setenv("DMMT_SLAB_B", "2")
    assert dt.encode_array(frames[0], 255, cfg, device="cpu") == want[0]
    assert dt.encode_batch(frames, 255, cfg, device="cpu") == want
    assert routes == ({"_start": 3, "_replay": 0} if path == "cpu" else {"_start": 0, "_replay": 3})
