"""PyTorch port: the band plan of a host frame's upload to a card
(programs.band_plan) and copy_in's other branches, on the CPU.

The plan is computed only, nothing allocated: every row of every image
and plane is in exactly one band, in order; a band is whole rows, at most
a ring slot and a 1/BAND_SHARE of the frame;
uint16 samples give bands of twice the bytes. The ring's band loop
(programs._Ring.upload) runs here over a host ring whose events do
nothing, with the native copier and numpy's, against one plain copy, for
every layout a program fills. The native copier (csrc/host_copy.c) at
chunk edges, with no worker and more, and two pools at once. A CPU
destination and a tensor source keep their plain copy and never reach a
ring. The benchmark's reader of the ring's share of fills
(perfbench/metrics/fill_staged_share.py) on synthetic traces. The ring on
a card: tests/test_torch_fill_ring_card.py."""

import math
import sys
import threading

import numpy as np
import pytest
import torch

from dmmt_jpeg_encoder_tpu_torch import programs
from dmmt_jpeg_encoder_tpu_torch.utils import native
from dmmt_jpeg_encoder_tpu_torch.utils.device import narrow_pixels
from perfbench import harness
from perfbench.trace import Event, Trace

# name -> shape of the host array, bands of a uint8 frame
PLANS = {
    "one row, smaller than a band": ((1, 1920, 3), 1),
    "two bands": ((728, 1920, 3), 2),
    "two bands and one row": ((729, 1920, 3), 3),
    "1080p": ((1080, 1920, 3), 2),
    "4K": ((2160, 3840, 3), 2),
    "21600x21600 tile": ((21600, 21600, 3), 84),
    "planar planes of exactly one slot": ((3, 256, 1 << 16), 3 * 1),
    "planar 1080p": ((3, 1080, 1920), 3 * 1),
    "slab of four 1088p": ((4, 1088, 1920, 3), 4 * 1),
    "planar slab of two": ((2, 3, 48, 64), 2 * 3),
}


def _rows(shape: tuple) -> tuple[int, tuple]:
    """(the row dimension, the leading shape) as the plan cuts a frame."""
    dim = len(shape) - (3 if shape[-1] == 3 else 2)
    return dim, shape[:dim]


@pytest.mark.parametrize("name", sorted(PLANS))
def test_band_plan_covers_every_row_once_in_order(name):
    shape, n_bands = PLANS[name]
    plan = programs.band_plan(shape, 1)
    dim, leading = _rows(shape)
    row_bytes = math.prod(shape[dim + 1:])
    assert len(plan) == n_bands
    want = [(index, r) for index in np.ndindex(*leading) for r in range(shape[dim])]
    assert [(index, r) for index, start, stop in plan for r in range(start, stop)] == want
    target = min(math.prod(shape) // programs.BAND_SHARE, programs.RING_SLOT_BYTES)
    for index, start, stop in plan:
        assert 0 < (stop - start) * row_bytes <= programs.RING_SLOT_BYTES
        # every band but an image's last is the target in whole rows
        if stop < shape[dim]:
            assert stop - start == max(1, target // row_bytes)


@pytest.mark.parametrize("shape", [(2160, 1920, 3), (123, 205, 3)])
def test_uint16_bands_hold_twice_the_bytes(shape):
    """Where no band is cut to a slot."""
    narrow = [(stop - start) for _, start, stop in programs.band_plan(shape, 1)]
    wide = [(stop - start) for _, start, stop in programs.band_plan(shape, 2)]
    assert wide == narrow  # the same rows, each of twice the bytes


def test_a_row_past_a_slot_is_cut_further():
    shape = (2, 3, 1, programs.RING_SLOT_BYTES + 6)  # planar rows of 16 MiB + 6
    plan = programs.band_plan(shape, 1)
    assert len(plan) == 2 * 3 * 1 * 2
    assert all(len(index) == 3 and stop - start <= programs.RING_SLOT_BYTES
               for index, start, stop in plan)


class _HostEvent:
    def synchronize(self):
        pass

    def record(self, stream):
        pass


@pytest.fixture(params=["native", "numpy"])
def host_ring(monkeypatch, request):
    """A _Ring over ordinary host memory, its events doing nothing, with
    the native copier or numpy's."""
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    ring = programs._Ring.__new__(programs._Ring)
    ring.host = torch.zeros(programs.RING_SLOTS * programs.RING_SLOT_BYTES, dtype=torch.uint8)
    ring.slots = ring.host.split(programs.RING_SLOT_BYTES)
    ring.arrays = [slot.numpy() for slot in ring.slots]
    ring.events = [_HostEvent() for _ in range(programs.RING_SLOTS)]
    ring.copy = _pool(3, 1 << 20) if request.param == "native" else np.copyto
    assert ring.copy is not None, "the native library did not build"
    ring.lock, ring.next = threading.Lock(), 0
    return ring


SOURCES = ("1080p", "planar", "slab", "window of a padded input", "non-contiguous source",
           "maxval 4095 from int32")


def _sources():
    """name (SOURCES) -> (destination, source, maxval)."""
    rng = np.random.default_rng(25)
    big = rng.integers(0, 256, (1100, 2000, 3), dtype=np.uint8)
    padded = torch.zeros((1088, 1920, 3), dtype=torch.uint8)
    return {
        "1080p": (torch.zeros((1080, 1920, 3), dtype=torch.uint8),
                  rng.integers(0, 256, (1080, 1920, 3), dtype=np.uint8), 255),
        "planar": (torch.zeros((3, 720, 1280), dtype=torch.uint8),
                   rng.integers(0, 256, (3, 720, 1280), dtype=np.uint8), 255),
        "slab": (torch.zeros((3, 400, 640, 3), dtype=torch.uint8),
                 rng.integers(0, 256, (3, 400, 640, 3), dtype=np.uint8), 255),
        "window of a padded input": (padded[:1080, :1900], big[:1080, :1900], 255),
        "non-contiguous source": (torch.zeros((1080, 1920, 3), dtype=torch.uint8),
                                  big[10:1090, 1920:0:-1], 255),
        "maxval 4095 from int32": (torch.zeros((123, 205, 3), dtype=torch.uint16),
                                   rng.integers(0, 4096, (123, 205, 3)).astype(np.int32), 4095),
    }


@pytest.mark.parametrize("name", SOURCES)
def test_ring_band_loop_equals_one_copy(host_ring, name):
    dst, src, maxval = _sources()[name]
    want = dst.clone()
    want.copy_(torch.from_numpy(np.ascontiguousarray(narrow_pixels(src, maxval))))
    host_ring.upload(dst, src, maxval)
    assert torch.equal(dst, want)
    assert host_ring.next == len(programs.band_plan(src.shape, dst.element_size())) % 4


@pytest.mark.parametrize("name", SOURCES)
def test_cpu_destination_and_tensor_source_copy_plainly(monkeypatch, name):
    def no_ring(device):
        raise AssertionError("a ring was asked for")

    monkeypatch.setattr(programs, "_ring", no_ring)
    dst, src, maxval = _sources()[name]
    want = torch.from_numpy(np.ascontiguousarray(narrow_pixels(src, maxval)))
    programs.copy_in(dst, src, maxval)
    assert torch.equal(dst, want)
    dst.zero_()
    programs.copy_in(dst, want.clone(), maxval)
    assert torch.equal(dst, want)


# (the stretch's program spans, the share the reader gives)
SHARES = {
    "every fill staged": ([("dmmt.fill", 1, 9), ("dmmt.fill_staged", 2, 8),
                           ("dmmt.fill_wait", 2, 3), ("dmmt.fill", 51, 59),
                           ("dmmt.fill_staged", 52, 58)], 1.0),
    "a pack's fill beside each": ([("dmmt.fill", 1, 9), ("dmmt.fill_staged", 2, 8),
                                   ("dmmt.fill", 20, 21), ("dmmt.fill", 51, 59),
                                   ("dmmt.fill_staged", 52, 58), ("dmmt.fill", 70, 71)], 0.5),
    "device tensors only": ([("dmmt.fill", 1, 9), ("dmmt.replay", 9, 10),
                             ("dmmt.fill", 51, 59)], 0.0),
    "no fill": ([("dmmt.replay", 9, 10), ("dmmt.stuff", 20, 30)], None),
    "no program span": ([], None),
}


@pytest.mark.parametrize("name", SHARES)
def test_fill_staged_share_reader(name):
    spans, want = SHARES[name]
    trace = Trace(requests=2, images=2, start=0.0, end=100.0)
    trace.host = [Event("request", 0, 45), Event("request", 50, 100),
                  *(Event(n, a, b) for n, a, b in spans)]
    run = harness.Run(device="cuda", trace=trace)
    assert harness.reader("fill_staged_share")(run) == want
    assert harness.reader("fill_staged_share")(harness.Run(device="cpu")) is None


CHUNK = 256 << 10  # csrc/host_copy.c's COPY_CHUNK


_POOLS: dict[tuple, object] = {}


def _pool(workers: int, bytes_per_helper: int = 1):
    """One native pool per (workers, bytes per helper) for this module (a
    pool's threads live as long as the process)."""
    key = (workers, bytes_per_helper)
    if key not in _POOLS:
        _POOLS[key] = native.copy_pool(workers, bytes_per_helper)
    return _POOLS[key]


# (workers, bytes per helper): none; one woken; three woken; three, one
# woken per 1 MiB (none for the small copies); seven, one per 4 chunks
POOL_SHAPES = [(0, 1), (1, 1), (3, 1), (3, 1 << 20), (7, 4 * CHUNK)]


@pytest.mark.parametrize("shape", POOL_SHAPES)
@pytest.mark.parametrize("n", [0, 1, CHUNK - 1, CHUNK, CHUNK + 1, 5 * CHUNK + 77, 13_000_003])
def test_native_copy_pool(shape, n):
    copy = _pool(*shape)
    src = np.random.default_rng(n).integers(0, 256, n + 16, dtype=np.uint8)
    dst = np.zeros(n + 16, np.uint8)
    for _ in range(3):
        dst[:] = 0
        copy(dst[8:8 + n], src[8:8 + n])
        assert np.array_equal(dst[8:8 + n], src[8:8 + n])
        assert not dst[:8].any() and not dst[8 + n:].any()


def test_native_copy_pool_refuses_unequal_or_strided_arrays():
    copy, src = _pool(1), np.arange(64, dtype=np.uint8)
    for dst, source in ((np.empty(63, np.uint8), src), (np.empty(32, np.uint8), src[::2]),
                        (np.empty((8, 16), np.uint8)[:, :8], src[:64].reshape(8, 8))):
        with pytest.raises(ValueError):
            copy(dst, source)


def test_native_copy_pools_on_two_threads():
    """Two pools of more workers than the machine has cores, each copying
    on its own thread at once, every copy checked."""
    rng = np.random.default_rng(7)
    srcs = [rng.integers(0, 256, size, dtype=np.uint8) for size in (3_000_001, 1_048_576)]
    copies = [native.copy_pool(16, 1), native.copy_pool(16, CHUNK)]
    errors = []

    def run(t):
        src, dst = srcs[t], np.empty_like(srcs[t])
        for r in range(40):
            dst[:] = 0
            copies[t](dst, src)
            if not np.array_equal(dst, src):
                errors.append((t, r))

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(t,)) for t in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(saved)
    assert not any(th.is_alive() for th in threads) and errors == []
