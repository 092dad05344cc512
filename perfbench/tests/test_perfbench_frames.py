"""The frame pool: the frozen generator's pattern, drawn from the seed."""

import numpy as np
import torch

from perfbench.frames import frame_pixels, frame_pool, pattern


def test_pattern_is_frame_pixels_without_its_noise():
    h, w, seed = 37, 131, 9
    noise = np.random.default_rng(seed).integers(-8, 9, size=(h, w, 3))
    expect = np.clip(pattern(h, w, "cpu").numpy().astype(np.int64) + noise, 0, 255)
    assert (frame_pixels(h, w, 255, seed) == expect).all()


def test_pool_is_seeded_and_distinct():
    a = frame_pool(24, 40, 3, 2**31 + 5, "cpu")
    b = frame_pool(24, 40, 3, 2**31 + 5, "cpu")
    c = frame_pool(24, 40, 3, 2**31 + 6, "cpu")
    assert all((x == y).all() for x, y in zip(a, b))
    assert not (a[0] == c[0]).all()
    assert not (a[0] == a[1]).all() and a[0].dtype == np.uint8 and a[0].shape == (24, 40, 3)
    base = pattern(24, 40, "cpu").to(torch.int64).numpy()
    assert np.abs(a[0].astype(np.int64) - np.clip(base, 0, 255)).max() <= 8


def test_pool_above_8_bits_scales_the_8_bit_frame():
    narrow = frame_pool(24, 40, 1, 2**31 + 5, "cpu")[0]
    wide = frame_pool(24, 40, 2, 2**31 + 5, "cpu", maxval=4095)
    assert wide[0].dtype == np.uint16 and int(wide[0].max()) <= 4095
    assert ((wide[0] // 16) == narrow).all() and not (wide[0] == wide[1]).all()
