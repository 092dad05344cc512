"""Small host constants kept on the device.

A blocking host->device copy from pageable memory synchronizes the whole
stream, so an encode that uploaded its quantization tables or kernel
constants each time would wait for every kernel queued before it, and a
pipeline of encodes would run one at a time. `device_constant` uploads
each distinct small array once per device and returns the same tensor
after that; callers must not modify it.
"""

from __future__ import annotations

import numpy as np
import torch

_CONSTANTS: dict[tuple, torch.Tensor] = {}


def device_constant(array: np.ndarray, device: torch.device) -> torch.Tensor:
    array = np.ascontiguousarray(array)
    key = (str(device), array.dtype.str, array.shape, array.tobytes())
    if key not in _CONSTANTS:
        _CONSTANTS[key] = torch.from_numpy(array.copy()).to(device)
    return _CONSTANTS[key]
