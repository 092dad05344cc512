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
(which go to the current card) run where their tensors lie.
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
