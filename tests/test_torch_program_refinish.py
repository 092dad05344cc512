"""PyTorch port: a state finished twice, and a two-dispatch result packed
twice, on the card path of the captured programs.

On a card a program's outputs are the same tensors on every replay, so a
state or result of one start holds tensors that the next replay of its
instance overwrites. In the JAX package a state's arrays never change: a
second finish_one_dispatch(state) returns the first one's bytes and
tables. Here `programs.Program` is replaced by SharingProgram, whose `run`
writes each run's results into the first run's tensors, as a replay does,
and `programs.target` names a card, so every start function takes its
card path (keys, caches, pools, leases) on the CPU. For each state kind
(single, slab, multi, sharded, sharded slab, sharded two-dispatch) a state
A is finished, a start B replays the same instance and is finished, and A
is finished again: it must give A's bytes and tables. For the
two-dispatch pipeline, pack_scan of one result twice, with another image's
replays in between, must give the same bytes. The tolerance is zero:
bytes must be identical."""

import dataclasses
import gc

import numpy as np
import pytest
import torch

import dmmt_jpeg_encoder_tpu_torch as dt
from dmmt_jpeg_encoder_tpu_torch import encoder as tenc
from dmmt_jpeg_encoder_tpu_torch import onedispatch as tod
from dmmt_jpeg_encoder_tpu_torch import pipeline as tpipe
from dmmt_jpeg_encoder_tpu_torch import programs
from dmmt_jpeg_encoder_tpu_torch.bitstream import device_pack as tpack
from dmmt_jpeg_encoder_tpu_torch.parallel import sharding as tshard
from dmmt_jpeg_encoder_tpu_torch.tables import quantization_table_pair
from dmmt_jpeg_encoder_tpu_torch.utils import capability

CARD = torch.device("cuda", 0)
SHAPE = (24, 40)
# every cache of captured programs, cleared after each test: a pool of
# SharingProgram instances must not serve another test file's starts
PROGRAM_CACHES = (
    (tod, "_compiled_onedispatch"), (tod, "_compiled_onedispatch_slab"),
    (tod, "_compiled_onedispatch_multi"), (tshard, "_compiled_sharded_onedispatch"),
    (tshard, "_compiled_sharded_onedispatch_slab"), (tshard, "_compiled_sharded"),
    (tshard, "_compiled_shard_pack"), (tpipe, "_compiled_pipeline"),
    (tpipe, "_compiled_pipeline_batch"), (tpack, "_compiled_fused_pack"),
    (tpack, "_compiled_pack"), (tpack, "_compiled_pack_batch"),
)


class SharingProgram:
    """A captured instance without the graph, whose outputs are shared as
    a graph's are: `run` fills the static input, runs the eager enqueue on
    the CPU and writes its results into the tensors that the first run
    returned; every run hands out programs.handle of those."""

    count = 0
    bytes = 0

    def __init__(self, kind, shape, dtype, device, enqueue, fill=programs.copy_in):
        self.kind, self.enqueue, self.fill = kind, enqueue, fill
        self.input = programs.static_input(shape, dtype, torch.device("cpu"))
        self.outputs = None
        SharingProgram.count += 1
        programs.PROGRAMS.add(self)

    def run(self, pixels, maxval):
        self.fill(self.input, pixels, maxval)
        fresh = self.enqueue(self.input, None)
        if self.outputs is None:
            self.outputs = fresh
        else:
            _write_into(self.outputs, fresh)
        return [programs.handle(out) for out in self.outputs]


def _write_into(dst, src):
    """Copy every tensor of `src` into the same place of `dst` (states,
    lists, tuples and dicts of tensors, walked alike)."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src):
            _write_into(d, s)
    elif isinstance(dst, dict):
        for k in dst:
            _write_into(dst[k], src[k])
    elif dataclasses.is_dataclass(dst):
        for f in dataclasses.fields(dst):
            _write_into(getattr(dst, f.name), getattr(src, f.name))


@pytest.fixture(autouse=True)
def sharing(monkeypatch):
    """Every start function takes its card path, with SharingProgram; the
    devices run the kernels (their plain versions here)."""
    for k in ("DMMT_P1", "DMMT_P1_PREC", "DMMT_HIST", "DMMT_NO_FUSED_PACK", "DMMT_SLAB_ONEPACK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(SharingProgram, "count", 0)
    monkeypatch.setattr(programs, "Program", SharingProgram)
    monkeypatch.setattr(programs, "target", lambda pixels, device: CARD)
    monkeypatch.setattr(capability, "kernels_capable", lambda device: True)
    yield
    for module, name in PROGRAM_CACHES:
        getattr(module, name).cache_clear()
    gc.collect()


def _images(seed: int, n: int) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (*SHAPE, 3)).astype(np.uint8) for _ in range(n)]


def _jpegs(cfg, results) -> list[bytes]:
    lq, cq = quantization_table_pair(cfg.quantization_preset, cfg.quality)
    return [tenc._jpeg(SHAPE, cfg, lq, cq, scan, tables) for scan, tables in results]


def _single(frames, cfg):
    lq, cq = quantization_table_pair(cfg.quantization_preset, cfg.quality)
    return [tod.start_one_dispatch(frames[0], 255, cfg, lq, cq)]


def _slab(frames, cfg):
    lq, cq = quantization_table_pair(cfg.quantization_preset, cfg.quality)
    return tod.start_one_dispatch_slab(np.stack(frames), 255, cfg, lq, cq)


def _multi(frames, cfg):
    lq, cq = quantization_table_pair(cfg.quantization_preset, cfg.quality)
    return tod.start_one_dispatch_multi(np.stack(frames), 255, cfg, lq, cq)


def _finish_one(states, cfg):
    return [tod.finish_one_dispatch(s, cfg) for s in states]


def _sharded(frames, cfg):
    return [tshard.start_sharded_encode(frames[0], 255, cfg, ["cpu"] * cfg.num_shards)]


def _sharded_slab(frames, cfg):
    return [tshard.start_sharded_encode_slab(frames, 255, cfg, ["cpu"] * cfg.num_shards)]


def _finish_sharded(states, cfg):
    (state,) = states
    if state.n_images > 1:
        return tshard.finish_sharded_encode_slab(state, cfg)
    return [tshard.finish_sharded_encode(state, cfg)]


KINDS = {
    "single": (_single, _finish_one, 1, 1),
    "slab": (_slab, _finish_one, 2, 1),
    "multi": (_multi, _finish_one, 2, 1),
    "sharded": (_sharded, _finish_sharded, 1, 2),
    "sharded_slab": (_sharded_slab, _finish_sharded, 2, 2),
    "sharded_twodispatch": (_sharded, _finish_sharded, 1, 2),
}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_second_finish_gives_the_first_finishs_bytes(monkeypatch, kind):
    """Start A and finish it; start B, which replays A's instance, and
    finish it; finish A again: A's bytes and tables, equal to the CPU's."""
    start, finish, n, shards = KINDS[kind]
    if kind == "sharded_twodispatch":  # past a device table bound of one symbol
        monkeypatch.setattr(tod, "MAX_DEVICE_TABLE_SYMBOLS", 1)
    cfg = dt.EncoderConfig(num_shards=shards)
    a, b = _images(70, n), _images(71, n)
    states = start(a, cfg)
    first = _jpegs(cfg, finish(states, cfg))
    other = _jpegs(cfg, finish(start(b, cfg), cfg))
    assert SharingProgram.count == (2 if kind == "sharded_twodispatch" else 1)
    assert other != first
    assert _jpegs(cfg, finish(states, cfg)) == first
    monkeypatch.setattr(programs, "target", lambda pixels, device: torch.device("cpu"))
    device = ["cpu"] * shards if shards > 1 else "cpu"
    assert first == [dt.encode_array(px, 255, cfg, device=device) for px in a]


@pytest.mark.parametrize("backend", ["fused", "staged", "host"])
def test_pack_scan_twice_gives_the_same_bytes(monkeypatch, backend):
    """run_device_pipeline on A, pack_scan; the same for B (another
    pipeline instance, since A's result holds its own, and the same pack
    instance); pack_scan of A's result again: A's bytes. Then B's result
    is collected and C's pipeline replays B's instance: A's bytes still."""
    if backend == "staged":
        monkeypatch.setenv("DMMT_NO_FUSED_PACK", "1")
    cfg = dt.EncoderConfig(one_dispatch="off", scan_backend="host" if backend == "host" else "auto")
    lq, cq = quantization_table_pair(cfg.quantization_preset, cfg.quality)
    a, b, c = _images(72, 3)

    def run(px):
        result = tpipe.run_device_pipeline(px, 255, cfg, lq, cq)
        return result, tenc.HuffmanTables.from_histograms(result)

    ra, ta = run(a)
    first = tenc.pack_scan(ra, ta, cfg)
    rb, tb = run(b)
    assert tenc.pack_scan(rb, tb, cfg) != first
    assert tenc.pack_scan(ra, ta, cfg) == first
    del rb
    gc.collect()
    rc, tc = run(c)
    tenc.pack_scan(rc, tc, cfg)
    assert tenc.pack_scan(ra, ta, cfg) == first
    assert SharingProgram.count == (2 if backend == "host" else 3)
    monkeypatch.setattr(programs, "target", lambda pixels, device: torch.device("cpu"))
    assert tenc._jpeg(SHAPE, cfg, lq, cq, first, ta) == dt.encode_array(a, 255, cfg, device="cpu")
