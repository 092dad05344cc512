"""Synthetic RGB frames from a seed.

`frame_pixels` is a frozen copy of `frame_pixels` in
dmmt_jpeg_encoder_tpu_torch/bench.py at commit 403a63c (lines 119-136),
itself the test fixtures' generator: a ramp, hard-edged tiles and a
sawtooth texture plus per-channel noise of -8..8, in integer-only numpy,
so every machine builds the same bytes. `frame_pool` makes the benchmark's
frames, at the configuration's `maxval`, from the same pattern (`pattern`, held equal to frame_pixels'
in the tests) with noise drawn by a torch.Generator on the device, so a
pool of 4K frames takes milliseconds, not seconds.
"""

from __future__ import annotations

import numpy as np
import torch


def frame_pixels(height: int, width: int, maxval: int = 255, seed=0) -> np.ndarray:
    """RGB [H, W, 3] samples; uint8, or uint16 when maxval > 255."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.int64)
    ramp = 40 + (xx * 150) // max(width - 1, 1) + (yy * 50) // max(height - 1, 1)
    tiles = ((xx // 53 + yy // 31) % 3) * 12
    wave = ((xx * 7 + yy * 3) % 64 - 32) // 4
    base = ramp + tiles + wave - 12
    rgb = base[..., None] + np.array([0, -10, 12]) + rng.integers(-8, 9, size=(height, width, 3))
    rgb = np.clip(rgb, 0, 255)
    if maxval <= 255:
        return rgb.astype(np.uint8)
    scale = (maxval + 1) // 256
    fine = rng.integers(0, scale, size=(height, width, 3))
    return np.clip(rgb * scale + fine, 0, maxval).astype(np.uint16)


def pattern(height: int, width: int, device) -> torch.Tensor:
    """The noise-free part of frame_pixels, int16 [H, W, 3] on `device`."""
    yy = torch.arange(height, dtype=torch.int64, device=device)[:, None]
    xx = torch.arange(width, dtype=torch.int64, device=device)[None, :]
    ramp = 40 + (xx * 150) // max(width - 1, 1) + (yy * 50) // max(height - 1, 1)
    tiles = ((xx // 53 + yy // 31) % 3) * 12
    wave = ((xx * 7 + yy * 3) % 64 - 32) // 4
    base = ramp + tiles + wave - 12
    return (base[..., None] + torch.tensor([0, -10, 12], device=device)).to(torch.int16)


def frame_pool(height: int, width: int, n: int, seed: int, device, maxval: int = 255) -> list[np.ndarray]:
    """n distinct host frames: frame_pixels' pattern plus noise of -8..8
    drawn on `device` by one torch.Generator seeded with `seed`, one call per
    frame; above 8 bits, scaled and given a fine part as frame_pixels does.
    uint8, or uint16 when maxval > 255; the same seed on the same kind of
    device gives the same frames."""
    base = pattern(height, width, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    scale = (maxval + 1) // 256
    out = []
    for _ in range(n):
        noise = torch.randint(-8, 9, (height, width, 3), generator=gen, device=device,
                              dtype=torch.int16)
        rgb = torch.clamp(base + noise, 0, 255)
        if maxval <= 255:
            out.append(rgb.to(torch.uint8).cpu().numpy())
            continue
        fine = torch.randint(0, scale, (height, width, 3), generator=gen, device=device,
                             dtype=torch.int32)
        wide = torch.clamp(rgb.to(torch.int32) * scale + fine, 0, maxval)
        out.append(wide.cpu().numpy().astype(np.uint16))
    return out
