"""PyTorch port, the one-dispatch programs (onedispatch.py on the runtime
of programs.py): the mode key
(utils/capability.trace_mode_key, mode_keyed_cache) against the JAX
package's, the three program caches' names and bounds, what a program key
separates, the lease pool of captured instances, and the CPU start
functions' bytes against the JAX package's encode_array.

A CUDA graph is captured only on a card (chip_smoke.py checks the
replays). Here `programs.Program` is replaced by a fake that runs the
eager enqueue on the CPU, and `programs.target` names a card, so the
start functions' card path (keys, caches, pools, leases) runs as it does
on a card, graph aside. The tolerance is
zero: bytes must be identical."""

import gc

import numpy as np
import pytest
import torch

import dmmt_jpeg_encoder_tpu as dj
from dmmt_jpeg_encoder_tpu import onedispatch as jod
from dmmt_jpeg_encoder_tpu_torch import encoder as tenc
from dmmt_jpeg_encoder_tpu_torch import onedispatch as tod
from dmmt_jpeg_encoder_tpu_torch import programs
from dmmt_jpeg_encoder_tpu_torch.config import ChromaSubsamplingPreset, DCTVariant, config_from_jax
from dmmt_jpeg_encoder_tpu_torch.kernels import build
from dmmt_jpeg_encoder_tpu_torch.tables import quantization_table_pair
from dmmt_jpeg_encoder_tpu_torch.utils import capability
from torch_port_fixtures import FIXTURES, fixture_pixels

KNOBS = {"DMMT_P1": "fused1", "DMMT_HIST": "matmul", "DMMT_P1_PREC": "high",
         "DMMT_SLAB_ONEPACK": "1", "DMMT_NO_FUSED_PACK": "1"}
CACHES = ("_compiled_onedispatch", "_compiled_onedispatch_slab", "_compiled_onedispatch_multi")
CARD = torch.device("cuda", 0)
P420 = ChromaSubsamplingPreset.P420


_JAX_BYTES: dict = {}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    yield
    for name in CACHES:
        getattr(tod, name).cache_clear()
    gc.collect()


class FakeProgram:
    """A captured instance without the graph: `run` copies the call's data
    into the static input (or inputs: programs.static_input, on the
    CPU) with the program's `fill`, counts one replay of its kind, and runs
    the eager enqueue over it on the CPU."""

    count = 0
    bytes = 0

    def __init__(self, kind, shape, dtype, device, enqueue, fill=programs.copy_in):
        self.kind, self.enqueue, self.fill = kind, enqueue, fill
        self.input = programs.static_input(shape, dtype, torch.device("cpu"))
        FakeProgram.count += 1
        programs.PROGRAMS.add(self)

    def run(self, pixels, maxval):
        self.fill(self.input, pixels, maxval)
        build.REPLAYS[self.kind] += 1
        return self.enqueue(self.input, None)


@pytest.fixture
def card_path(monkeypatch):
    """The start functions take their card path, with FakeProgram."""
    monkeypatch.setattr(FakeProgram, "count", 0)
    monkeypatch.setattr(programs, "Program", FakeProgram)
    monkeypatch.setattr(programs, "target", lambda pixels, device: CARD)
    return FakeProgram


def _fixture(name):
    f = FIXTURES[name]
    jax_cfg = dj.EncoderConfig(chroma_subsampling=dj.ChromaSubsamplingPreset(f["preset"]),
                               quality=f["quality"])
    cfg = config_from_jax(jax_cfg)
    return fixture_pixels(name), f["maxval"], jax_cfg, cfg, *quantization_table_pair(
        cfg.quantization_preset, cfg.quality)


def _jpegs(states, cfg, lq, cq, shape):
    return [tenc._jpeg(shape, cfg, lq, cq, *tod.finish_one_dispatch(s, cfg)) for s in states]


def _pool_args(n_images=None, maxval=255, planar=False, pixels=None, lq=None, cq=None):
    cfg = tenc.EncoderConfig()
    dlq, dcq = quantization_table_pair(cfg.quantization_preset, cfg.quality)
    pixels = np.zeros((16, 16, 3), np.uint8) if pixels is None else pixels
    head = () if n_images is None else (n_images,)
    return (*head, 16, 16, P420, DCTVariant.ARAI, planar,
            *programs.program_key(pixels, maxval, dlq if lq is None else lq, dcq if cq is None else cq,
                             CARD))


def _pool_of(start, px, maxval, cfg, lq, cq):
    """The pool a start function's card path leases from for `px` (a
    group of two for the slab and multi starts)."""
    key = (cfg.chroma_subsampling, cfg.dct_variant, False)
    if start is tod.start_one_dispatch:
        return tod._compiled_onedispatch(*px.shape[:2], *key,
                                         *programs.program_key(px, maxval, lq, cq, CARD))
    cache = (tod._compiled_onedispatch_slab if start is tod.start_one_dispatch_slab
               else tod._compiled_onedispatch_multi)
    return cache(2, *px.shape[:2], *key, *programs.program_key(px, maxval, lq, cq, CARD))


@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_trace_mode_key_changes_with_each_knob(monkeypatch, knob):
    base = capability.trace_mode_key()
    monkeypatch.setenv(knob, KNOBS[knob])
    assert capability.trace_mode_key() != base
    monkeypatch.delenv(knob)
    assert capability.trace_mode_key() == base


@pytest.mark.parametrize("name", CACHES)
def test_knob_toggled_after_build_gives_new_entry(monkeypatch, name):
    cache = getattr(tod, name)
    cache.cache_clear()
    args = _pool_args(None if name == "_compiled_onedispatch" else 2)
    first = cache(*args)
    assert cache(*args) is first
    monkeypatch.setenv("DMMT_P1", "fused1")
    toggled = cache(*args)
    assert toggled is not first and cache(*args) is toggled
    assert cache.cache_info().currsize == 2
    monkeypatch.delenv("DMMT_P1")
    assert cache(*args) is first


@pytest.mark.parametrize("name", CACHES)
def test_cache_bounds_equal_the_jax_packages(name):
    def maxsize(fn):
        return fn.cache_clear.__self__.cache_parameters()["maxsize"]

    assert maxsize(getattr(tod, name)) == maxsize(getattr(jod, name)) == {
        "_compiled_onedispatch": 32, "_compiled_onedispatch_slab": 8,
        "_compiled_onedispatch_multi": 8}[name]


@pytest.mark.parametrize("name", CACHES)
@pytest.mark.parametrize("change", [
    dict(maxval=254), dict(maxval=4095), dict(planar=True),
    dict(zip(("lq", "cq"), quantization_table_pair(tenc.EncoderConfig().quantization_preset, 75))),
    dict(pixels=torch.zeros((16, 16, 3), dtype=torch.uint16)),
    dict(pixels=torch.zeros((16, 16, 3), dtype=torch.int16)),
], ids=["maxval", "maxval_16bit", "planar", "quant_tables", "tensor_uint16", "tensor_int16"])
def test_program_key_separates(name, change):
    cache = getattr(tod, name)
    n = None if name == "_compiled_onedispatch" else 2
    base = cache(*_pool_args(n))
    assert cache(*_pool_args(n, **change)) is not base
    assert cache(*_pool_args(n)) is base


def test_program_key_separates_n_images():
    for name in CACHES[1:]:
        cache = getattr(tod, name)
        assert cache(*_pool_args(2)) is not cache(*_pool_args(3))
    # a uint8 host array, a uint16 one at maxval 255 (narrowed for the copy)
    # and a uint8 tensor key alike
    u8 = np.zeros((16, 16, 3), np.uint8)
    assert (programs.program_key(u8, 255, u8, u8, CARD)[1]
            == programs.program_key(u8.astype(np.uint16), 255, u8, u8, CARD)[1]
            == programs.program_key(torch.from_numpy(u8), 255, u8, u8, CARD)[1] == torch.uint8)


def test_lease_held_until_finish(card_path):
    px, maxval, _, cfg, lq, cq = _fixture("7x17_p444")
    state = tod.start_one_dispatch(px, maxval, cfg, lq, cq)
    pool = _pool_of(tod.start_one_dispatch, px, maxval, cfg, lq, cq)
    assert card_path.count == 1 and pool.idle == []
    tod.finish_one_dispatch(state, cfg)
    assert len(pool.idle) == 1
    # the next start leases the same instance
    tod.finish_one_dispatch(tod.start_one_dispatch(px, maxval, cfg, lq, cq), cfg)
    assert card_path.count == 1 and len(pool.idle) == 1


def test_lease_returned_when_state_collected(card_path):
    px, maxval, _, cfg, lq, cq = _fixture("7x17_p444")
    state = tod.start_one_dispatch(px, maxval, cfg, lq, cq)
    pool = _pool_of(tod.start_one_dispatch, px, maxval, cfg, lq, cq)
    assert pool.idle == []
    del state
    gc.collect()
    assert len(pool.idle) == 1


def test_busy_pool_builds_another(card_path):
    px, maxval, _, cfg, lq, cq = _fixture("7x17_p444")
    states = [tod.start_one_dispatch(px, maxval, cfg, lq, cq) for _ in range(3)]
    assert card_path.count == 3
    jpegs = _jpegs(states[::-1], cfg, lq, cq, px.shape)
    assert len(set(jpegs)) == 1
    again = [tod.start_one_dispatch(px, maxval, cfg, lq, cq) for _ in range(3)]
    assert card_path.count == 3
    assert _jpegs(again, cfg, lq, cq, px.shape) == jpegs


@pytest.mark.parametrize("start", [tod.start_one_dispatch_slab, tod.start_one_dispatch_multi])
def test_group_lease_returns_after_its_last_state(card_path, start):
    px, maxval, _, cfg, lq, cq = _fixture("7x17_p444")
    px = tod.mcu_padded_stack(px[None], maxval, cfg.chroma_subsampling)[0]
    first, second = start(np.stack([px, px[::-1]]), maxval, cfg, lq, cq)
    pool = _pool_of(start, px, maxval, cfg, lq, cq)
    assert card_path.count == 1 and pool.idle == []
    tod.finish_one_dispatch(first, cfg)
    assert pool.idle == []
    del second
    gc.collect()
    assert len(pool.idle) == 1


def test_graph_memory_bound(card_path, monkeypatch):
    """Past GRAPH_MAX_BYTES the idle instances of every key go; a start
    raises when the leased ones alone hold that much."""
    px, maxval, _, cfg, lq, cq = _fixture("7x17_p444")
    gc.collect()
    assert tod.graph_bytes is programs.graph_bytes  # the benchmark reads it on onedispatch
    assert programs.graph_bytes() == 0
    monkeypatch.setattr(FakeProgram, "bytes", 10)
    monkeypatch.setattr(programs, "GRAPH_MAX_BYTES", 25)
    held = [tod.start_one_dispatch(px, maxval, cfg, lq, cq) for _ in range(3)]
    assert programs.graph_bytes() == 30
    with pytest.raises(RuntimeError, match="GRAPH_MAX_BYTES"):
        tod.start_one_dispatch(px, maxval, cfg, lq, cq)
    for state in held:
        tod.finish_one_dispatch(state, cfg)
    # another key: its first start drops the three idle instances
    other = tod.start_one_dispatch(px, maxval - 1, cfg, lq, cq)
    assert card_path.count == 4 and programs.graph_bytes() == 10
    tod.finish_one_dispatch(other, cfg)


@pytest.mark.parametrize("path", ["cpu", "card"])
@pytest.mark.parametrize("name", ["7x17_p444", "333x1001_p422"])
def test_start_functions_give_jax_bytes(request, path, name):
    """The CPU start functions (eager `_enqueue`), and their card path with
    FakeProgram, against the JAX package's encode_array: one image,
    interleaved and planar; a slab and a multi group of two."""
    if path == "card":
        request.getfixturevalue("card_path")
    px, maxval, jax_cfg, cfg, lq, cq = _fixture(name)
    if name not in _JAX_BYTES:
        _JAX_BYTES[name] = dj.encode_array(px, maxval, jax_cfg)
    planar = np.ascontiguousarray(px.transpose(2, 0, 1))
    stack = np.stack([px, px])
    runs = {
        "single": [tod.start_one_dispatch(px, maxval, cfg, lq, cq, device="cpu")],
        "single planar": [tod.start_one_dispatch(planar, maxval, cfg, lq, cq, device="cpu")],
        "slab": tod.start_one_dispatch_slab(stack, maxval, cfg, lq, cq, device="cpu"),
        "multi": tod.start_one_dispatch_multi(stack, maxval, cfg, lq, cq, device="cpu"),
    }
    for label, states in runs.items():
        assert _jpegs(states, cfg, lq, cq, px.shape) == [_JAX_BYTES[name]] * len(states), label
