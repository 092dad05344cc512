"""Host arrays on the device, without synchronizing the stream.

A blocking host->device copy from pageable memory synchronizes the whole
stream, so an encode that uploaded its quantization tables or kernel
constants each time would wait for every kernel queued before it, and a
pipeline of encodes would run one at a time. `device_constant` uploads
each distinct small array once per device and returns the same tensor
after that; callers must not modify it. `upload` copies a per-image array
(code tables, block offsets) through pinned memory, asynchronously.
`narrow_pixels` and `as_device` bring an image's samples to the device.
`on_device` makes a card current, so that kernels launched through ctypes
(which go to the current card) run where their tensors lie. The other
way: `pinned_copy` brings a finish's small results to pinned host memory
behind the work that made them, and `side_streams` gives a card's upload
and fetch streams.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

_CONSTANTS: dict[tuple, torch.Tensor] = {}


def device_constant(array: np.ndarray, device: torch.device) -> torch.Tensor:
    array = np.ascontiguousarray(array)
    key = (str(device), array.dtype.str, array.shape, array.tobytes())
    if key not in _CONSTANTS:
        _CONSTANTS[key] = torch.from_numpy(array.copy()).to(device)
    return _CONSTANTS[key]


def upload(array: np.ndarray, device: torch.device | str) -> torch.Tensor:
    """A fresh device copy of a host array: on a card through pinned memory
    with a non-blocking copy (the pinned block is kept until the copy ends),
    on the CPU a copy of the array."""
    host = torch.from_numpy(np.ascontiguousarray(array))
    if torch.device(device).type != "cuda":
        return host.clone()
    return host.pin_memory().to(device, non_blocking=True)


def narrow_pixels(pixels: np.ndarray, maxval: int) -> np.ndarray:
    """The upload dtype: uint8 when maxval <= 255, else uint16 (PPM samples
    are at most 16 bits)."""
    dtype = np.uint8 if maxval <= 255 else np.uint16
    return pixels if pixels.dtype == dtype else pixels.astype(dtype)


def as_device(pixels: np.ndarray | torch.Tensor, maxval: int, device) -> torch.Tensor:
    """A device tensor is used as it is; host samples are narrowed and
    uploaded (pageable copy)."""
    if isinstance(pixels, torch.Tensor):
        return pixels
    return torch.from_numpy(np.ascontiguousarray(narrow_pixels(pixels, maxval))).to(device)


def on_device(device: torch.device):
    """A context in which `device` (a card) is the current CUDA device; no
    effect for the CPU."""
    device = torch.device(device)
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


_SIDE_STREAMS: dict[int, tuple[torch.cuda.Stream, torch.cuda.Stream]] = {}


def side_streams(device: torch.device) -> tuple[torch.cuda.Stream, torch.cuda.Stream]:
    """(upload, fetch) streams of a CUDA device, made once: host->device
    uploads and device->host word fetches each run on their own stream,
    beside the compute (current) stream."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SIDE_STREAMS:
        _SIDE_STREAMS[index] = (torch.cuda.Stream(index), torch.cuda.Stream(index))
    return _SIDE_STREAMS[index]


def pinned_copy(parts: list[torch.Tensor]) -> tuple[torch.Tensor, torch.cuda.Event | None]:
    """(host tensor, event): `parts` (on one device) flattened, as int64 and
    concatenated, then on a card copied into pinned host memory behind the
    work queued on the current stream, with an event recorded after the
    copy; on the CPU the concatenation itself and no event."""
    small = torch.cat([p.reshape(-1).to(torch.int64) for p in parts])
    if small.device.type != "cuda":
        return small, None
    host = torch.empty(small.shape, dtype=small.dtype, pin_memory=True)
    host.copy_(small, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record()
    return host, ready
