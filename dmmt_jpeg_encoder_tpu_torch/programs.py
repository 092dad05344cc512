"""The runtime of captured programs: CUDA graphs of an eager enqueue,
pooled and leased per program key.

The JAX package compiles each device program into ONE jitted program,
cached by geometry and trace_mode_key(). On a card every program of the
port is a CUDA graph run by this module: the one-dispatch starts
(onedispatch.py), the two-dispatch halves (pipeline.py,
bitstream/device_pack.py) and the sharded encode on one card
(parallel/sharding.py). Each keeps a cache named as the JAX package's
program (utils/capability.mode_keyed_cache) of a `Pool` per key: the JAX
key plus program_key. A call leases a captured instance (`Program`),
fills its static input and replays its graph, one launch on the current
stream; a start holds the lease until its states are finished or
collected (`start`), a pack gives it back after its read (`run_once`). A
pool whose instances are all leased captures another, within
GRAPH_MAX_BYTES of graph memory; a failed capture raises, with no eager
fallback on a card. `target` and `card` decide where a call runs; the
CPU runs the eager enqueue. A fill copies a large host array into a
card's input through that card's pinned ring, band by band (`copy_in`).
"""

from __future__ import annotations

import dataclasses
import gc
import math
import threading
import weakref
from collections import Counter
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from .kernels import build
from .ops.block_hist import new_state
from .utils.device import narrow_pixels, on_device
from .utils.native import copy_pool
from .utils.profiling import span

# Graph memory of all captured instances (each its pool's bytes, as
# measured at capture) beyond the one being built. A single-image 4K P420
# instance holds 132 MB on an H100; a slab instance grows with its group,
# whose worst-case words alone may reach onedispatch.SLAB_MAX_WORD_BYTES.
GRAPH_MAX_BYTES = 16 << 30

_LOCK = threading.RLock()  # pool lists; a collected state gives back from any thread
PROGRAMS: weakref.WeakSet = weakref.WeakSet()  # every live captured instance
POOLS: weakref.WeakSet = weakref.WeakSet()     # every live pool
_CAPTURE_STREAMS: dict[int, torch.cuda.Stream] = {}


def target(pixels: np.ndarray | torch.Tensor, device) -> torch.device:
    """Where an encode runs: a tensor where it lies, a host array on
    `device` (a card with its index)."""
    dev = pixels.device if isinstance(pixels, torch.Tensor) else torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def card(pixels: np.ndarray | torch.Tensor, device) -> torch.device | None:
    """The card on which a call replays its program: `target` when that is
    a card. `device` may be a list of shard devices: every shard on one
    card. None (the eager enqueue) for the CPU or several distinct
    devices."""
    if isinstance(device, (list, tuple)):
        if len(set(device)) != 1:
            return None
        device = device[0]
    dev = target(pixels, device)
    return dev if dev.type == "cuda" else None


# The pinned ring through which copy_in uploads a host array of more than
# RING_MIN_BYTES to a card: RING_SLOTS slots of RING_SLOT_BYTES each, one
# ring per card, allocated at the first such fill on that card and kept for
# the life of the process. A smaller array takes CUDA's own pageable copy,
# which was as fast or faster at 6.2 MB on an H100's host: the ring's own
# costs (the last band's DMA after its host copy, ~0.1-0.2 ms of host calls
# a band) outweigh what its faster host copy saves there. A band is a
# 1/BAND_SHARE of the array and at most a slot, in whole rows.
# A band's host copy runs on the caller's thread and one native worker of
# the ring's own for each COPY_BYTES_PER_HELPER of the band, at most
# COPY_THREADS - 1 (utils/native.copy_pool): a worker woken for a small
# band costs more than it copies.
RING_SLOTS = 4
RING_SLOT_BYTES = 16 << 20
RING_MIN_BYTES = RING_SLOT_BYTES
BAND_SHARE = 2
COPY_THREADS = 8
COPY_BYTES_PER_HELPER = 2 << 20
RING_ALLOCATIONS: Counter = Counter()  # card index -> pinned rings allocated
_RINGS: dict[int, "_Ring"] = {}


def band_plan(shape: tuple, itemsize: int) -> list[tuple[tuple, int, int]]:
    """The bands in which copy_in uploads a host array of `shape` and
    `itemsize`: (index into the leading dimensions, first row, end row),
    in order, each band whole rows of one image and plane. A row is the
    last two dimensions of an interleaved array ([..., H, W, 3]) and the
    last one of a planar one ([..., 3, H, W]), split further where a row
    would not fit a slot."""
    dim = max(0, len(shape) - (3 if shape[-1] == 3 else 2))
    while dim < len(shape) - 1 and math.prod(shape[dim + 1:]) * itemsize > RING_SLOT_BYTES:
        dim += 1
    row_bytes = math.prod(shape[dim + 1:]) * itemsize
    band_bytes = min(math.prod(shape) * itemsize // BAND_SHARE, RING_SLOT_BYTES)
    rows, step = shape[dim], max(1, band_bytes // row_bytes)
    return [(index, start, min(start + step, rows))
            for index in np.ndindex(*shape[:dim]) for start in range(0, rows, step)]


class _Ring:
    """One card's pinned ring: RING_SLOTS slots taken in turn, each with
    the event of the last copy out of it, and the copier of a band into a
    slot (numpy's, where the native library is not built); the lock keeps
    two threads that fill at once off each other's slots."""

    def __init__(self, index: int):
        self.host = torch.empty(RING_SLOTS * RING_SLOT_BYTES, dtype=torch.uint8, pin_memory=True)
        self.slots = self.host.split(RING_SLOT_BYTES)
        self.arrays = [slot.numpy() for slot in self.slots]
        self.events = [torch.cuda.Event() for _ in range(RING_SLOTS)]
        self.copy = copy_pool(COPY_THREADS - 1, COPY_BYTES_PER_HELPER) or np.copyto
        self.lock = threading.Lock()
        self.next = 0
        RING_ALLOCATIONS[index] += 1

    def upload(self, dst: torch.Tensor, pixels: np.ndarray, maxval: int) -> None:
        """Each band narrowed to the upload dtype and copied on the host
        into the next slot, then copied to its rows of `dst` on the current
        stream: the card moves one band while the host copies the next, and
        the work queued after the fill follows the last band in stream
        order. Every byte of `pixels` has been read when this returns."""
        stream = torch.cuda.current_stream(dst.device)
        dtype = narrow_pixels(pixels[:0], maxval).dtype
        torch_dtype = torch.from_numpy(np.empty(0, dtype)).dtype
        for index, start, stop in band_plan(pixels.shape, dtype.itemsize):
            band = np.ascontiguousarray(narrow_pixels(pixels[index][start:stop], maxval))
            k, self.next = self.next, (self.next + 1) % RING_SLOTS
            with span("dmmt.fill_wait"):
                self.events[k].synchronize()
            n = band.nbytes
            self.copy(self.arrays[k][:n].view(dtype).reshape(band.shape), band)
            host = self.slots[k][:n].view(torch_dtype).view(band.shape)
            dst[index][start:stop].copy_(host, non_blocking=True)
            self.events[k].record(stream)


def _ring(device: torch.device) -> _Ring:
    index = device.index if device.index is not None else torch.cuda.current_device()
    with _LOCK:
        if index not in _RINGS:
            _RINGS[index] = _Ring(index)
        return _RINGS[index]


def copy_in(dst: torch.Tensor, pixels: np.ndarray | torch.Tensor, maxval: int) -> None:
    """Copy samples into a program's input (or a window of it): a tensor
    with one device copy; a host array of more than RING_MIN_BYTES into a
    card's input through the card's pinned ring (_Ring.upload), any other
    host array with one copy (pageable, to a card)."""
    if isinstance(pixels, torch.Tensor):
        dst.copy_(pixels)
    elif dst.device.type == "cuda" and dst.element_size() * pixels.size > RING_MIN_BYTES:
        ring = _ring(dst.device)
        with span("dmmt.fill_staged"), ring.lock:
            ring.upload(dst, pixels, maxval)
    else:
        dst.copy_(torch.from_numpy(np.ascontiguousarray(narrow_pixels(pixels, maxval))))


def _table_key(q: np.ndarray) -> tuple:
    q = np.ascontiguousarray(q)
    return q.dtype.str, q.shape, q.tobytes()


def key_table(key: tuple) -> np.ndarray:
    """The quantization table of one of program_key's table entries."""
    dtype, shape, raw = key
    return np.frombuffer(raw, dtype=dtype).reshape(shape)


def program_key(pixels, maxval: int, luma_q: np.ndarray, chroma_q: np.ndarray,
                device: torch.device) -> tuple:
    """What a capture bakes in beyond the JAX package's key: the device, the
    input dtype, maxval and the quantization tables' bytes."""
    if isinstance(pixels, torch.Tensor):
        dtype = pixels.dtype
    else:
        dtype = torch.from_numpy(narrow_pixels(np.asarray(pixels[:0]), maxval)).dtype
    return device, dtype, int(maxval), _table_key(luma_q), _table_key(chroma_q)


@dataclass(frozen=True)
class HostStaging:
    """The dtype of a program input that lives in host memory (pinned on a
    card): what a fill writes on the host and copies into a device input
    of the same instance (the packs' tables). The instance owns it, so it
    is rewritten only by the next start that leases the instance, after
    the previous one has waited for its outputs."""

    dtype: torch.dtype


def static_input(shape: tuple, dtype, device: torch.device):
    """A program's static input, zeroed: a tensor of `shape` and `dtype` on
    `device`; for a tuple of dtypes, a tuple of such tensors, one per
    (shape, dtype) pair. A HostStaging dtype makes host memory, pinned
    where `device` is a card."""
    if isinstance(dtype, tuple):
        return tuple(static_input(s, d, device) for s, d in zip(shape, dtype))
    if isinstance(dtype, HostStaging):
        return torch.zeros(shape, dtype=dtype.dtype, pin_memory=device.type == "cuda")
    return torch.zeros(shape, dtype=dtype, device=device)


def handle(output):
    """A replay's own handle on one output of the capture: a shallow copy
    of a state, a new tensor object over a tensor's memory (so that its
    collection can end a lease), anything else as it is."""
    if isinstance(output, torch.Tensor):
        return output.view_as(output)
    if dataclasses.is_dataclass(output):
        return dataclasses.replace(output)
    return output


class Program:
    """One captured instance of a program on a card: a static input
    (zeroed once; a tuple of them where `dtype` is a tuple, static_input),
    the CUDA graph of `enqueue(input, state)`, the outputs its capture
    returned (states, tensors or tuples of them: the graph's outputs), the
    launch counts the capture added, and the bytes its memory pool holds.
    `fill(input, pixels, maxval)` writes a call's data into the input
    (default copy_in: all of it)."""

    def __init__(self, kind: str, shape: tuple, dtype, device: torch.device,
                 enqueue: Callable[[torch.Tensor, torch.Tensor | None], list],
                 fill: Callable[[torch.Tensor, object, int], None] = copy_in):
        self.kind, self.device, self.stream, self.fill = kind, device, None, fill
        with torch.cuda.device(device), span("dmmt.capture"):
            if device.index not in _CAPTURE_STREAMS:
                _CAPTURE_STREAMS[device.index] = torch.cuda.Stream(device)
            capture = _CAPTURE_STREAMS[device.index]
            saved = build.launch_counts()
            try:
                self.input = static_input(shape, dtype, device)
                capture.wait_stream(torch.cuda.current_stream(device))
                with torch.cuda.stream(capture):
                    enqueue(self.input, None)  # warm-up, eager
                # the graph bakes in this state's pointer: it lives as long as the graph
                self.hist_state = new_state(device)
                # the whole card waits and its cache is emptied here, beside
                # whatever another thread enqueues, replays or captures on it
                torch.cuda.synchronize(device)
                gc.collect()
                torch.cuda.empty_cache()
                reserved = torch.cuda.memory_reserved(device)
                before = build.launch_counts()
                self.graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(self.graph, stream=capture, capture_error_mode="thread_local"):
                    self.states = enqueue(self.input, self.hist_state)
                after = build.launch_counts()
            finally:
                build.LAUNCHES.update(saved)  # the warm-up and the capture launch for no caller
            self.launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
            self.bytes = torch.cuda.memory_reserved(device) - reserved
        PROGRAMS.add(self)

    def run(self, pixels, maxval: int) -> list:
        """Fill the input and replay, on the current stream (after the
        stream of the last replay, when it is another one); one handle per
        output of the capture."""
        with on_device(self.device):
            stream = torch.cuda.current_stream(self.device)
            if self.stream is not None and self.stream != stream:
                stream.wait_stream(self.stream)
            with span("dmmt.fill"):
                self.fill(self.input, pixels, maxval)
            with span("dmmt.replay"):
                self.graph.replay()
            self.stream = stream
        for k, n in self.launches.items():
            build.LAUNCHES[k] += n
        build.REPLAYS[self.kind] += 1
        return [handle(state) for state in self.states]


def graph_bytes() -> int:
    """Graph memory held by the live captured instances."""
    return sum(p.bytes for p in list(PROGRAMS))


def _make_room() -> None:
    """Keep the instances within GRAPH_MAX_BYTES before another is built:
    drop every idle one when they hold that much, and raise when the
    leased ones alone do."""
    if graph_bytes() < GRAPH_MAX_BYTES:
        return
    with span("dmmt.evict"):
        with _LOCK:
            for p in list(POOLS):
                p.idle.clear()
        gc.collect()
    if graph_bytes() >= GRAPH_MAX_BYTES:
        raise RuntimeError(
            f"captured programs in use hold {graph_bytes()} bytes of graph memory, at least "
            f"GRAPH_MAX_BYTES ({GRAPH_MAX_BYTES}); finish or drop started states first")


class Pool:
    """The captured instances of one program key: the idle ones, and
    `make` to capture another when every instance is leased."""

    def __init__(self, make: Callable[[], Program]):
        self.make = make
        self.idle: list[Program] = []
        POOLS.add(self)

    def lease(self) -> Program:
        """An idle instance, or a new capture. The capture runs outside the
        lock, so two threads that find the pool busy at once capture side
        by side on one card."""
        with span("dmmt.lease"):
            with _LOCK:
                if self.idle:
                    return self.idle.pop()
            _make_room()
            return self.make()

    def give_back(self, program: Program) -> None:
        with _LOCK:
            self.idle.append(program)


class _Lease:
    """One start's hold on its instance, given back when the last of the
    start's states is finished or collected."""

    def __init__(self, pool: Pool, program: Program, n_states: int):
        self.pool, self.program, self.left = pool, program, n_states

    def release_one(self) -> None:
        with _LOCK:
            self.left -= 1
            if self.left == 0:
                self.pool.give_back(self.program)


def start(pool: Pool, pixels, maxval: int) -> list:
    """Lease an instance of `pool`, run it on the samples, and tie its
    lease to the states it returns (a state's `release`, or a tensor's
    collection). Since a later replay overwrites a finished state's
    tensors, a finish keeps its result on the state, and a second finish
    returns it, as a JAX state, whose arrays never change, gives the same
    bytes again."""
    program = pool.lease()
    try:
        states = program.run(pixels, maxval)
    except BaseException:
        pool.give_back(program)
        raise
    lease = _Lease(pool, program, len(states))
    for state in states:
        release = weakref.finalize(state, lease.release_one)
        if not isinstance(state, torch.Tensor):
            state.release = release
    return states


def run_once(pool: Pool, args, read: Callable):
    """Lease an instance of `pool`, run it on `args`, and return
    `read(*output)` of its one output; the instance is given back once
    `read` has waited for what it needs (nothing of it escapes)."""
    program = pool.lease()
    try:
        (output,) = program.run(args, 0)
        return read(*output)
    finally:
        pool.give_back(program)


def pool(kind: str, shape: tuple, dtype, device: torch.device, enqueue: Callable,
         fill: Callable = copy_in) -> Pool:
    """A pool of `kind` (a build.REPLAYS key) whose instances capture
    `enqueue` over a static input of `shape` and `dtype` on `device`."""
    return Pool(lambda: Program(kind, shape, dtype, device, enqueue, fill))
