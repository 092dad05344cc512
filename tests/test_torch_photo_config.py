"""PyTorch port, the benchmark's `gfx100_p444_q95` configuration: 16-bit
11648x8736 camera frames at 4:4:4, Annex K tables at quality 95
(perfbench/configs/gfx100_p444_q95.json), on the one-dispatch program.

On the CPU: the device table bound per table (`one_dispatch_supported`:
the luma table's worst case and the chroma table's, which Cb and Cr
share, so at P444 twice the luma one), with the bound patched down and
at its real value; the port's bytes at the configuration's settings
against the benchmark's plain reference and the JAX package's
`encode_array` on small seeded frames with ragged edges; and the bands
in which the pinned ring uploads a whole frame."""

import json
from pathlib import Path

import numpy as np
import pytest

import dmmt_jpeg_encoder_tpu as dj
import dmmt_jpeg_encoder_tpu_torch as dt
from dmmt_jpeg_encoder_tpu_torch import encoder as tenc
from dmmt_jpeg_encoder_tpu_torch import onedispatch as tod
from dmmt_jpeg_encoder_tpu_torch import programs
from dmmt_jpeg_encoder_tpu_torch.config import ChromaSubsamplingPreset
from dmmt_jpeg_encoder_tpu_torch.ops.geometry import padded_size
from perfbench import frames, harness, reference

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "perfbench" / "configs" / "gfx100_p444_q95.json").read_text())
FRAME = (CONFIG["height"], CONFIG["width"])
P444, P422, P420 = (ChromaSubsamplingPreset(p) for p in ("P444", "P422", "P420"))
# shapes of the benchmark's other configurations: their routes must not move
OTHER_CELLS = [((2160, 3840), P420, True), ((1080, 1920), P420, True),
               ((21600, 21600), P420, False)]


def luma_only(height, width, preset) -> bool:
    """The guard before it bounded the chroma table too: 64 * luma blocks."""
    ph, pw = padded_size(height, width, preset)
    return (ph // 8) * (pw // 8) * 64 < tod.MAX_DEVICE_TABLE_SYMBOLS


def test_p444_is_sent_to_two_dispatch_by_its_chroma_table(monkeypatch):
    """16x32 at P444: 8 luma blocks (512 symbols, under a bound of 640)
    but 16 chroma blocks in the shared table (1,024): two-dispatch."""
    monkeypatch.setattr(tod, "MAX_DEVICE_TABLE_SYMBOLS", 64 * 10)
    assert luma_only(16, 32, P444) is True
    assert tod.one_dispatch_supported(16, 32, P444) is False
    assert tod.one_dispatch_supported(16, 16, P444) is True  # 4 luma, 8 chroma blocks
    px = frames.frame_pixels(16, 32, CONFIG["maxval"], 2**31 + 41)
    config = harness.encoder_config(dt, CONFIG)
    ran = []
    real = tenc.run_device_pipeline
    monkeypatch.setattr(tenc, "run_device_pipeline", lambda *a, **k: ran.append(1) or real(*a, **k))
    monkeypatch.setattr(tenc, "start_one_dispatch", lambda *a, **k: pytest.fail("one dispatch ran"))
    got = dt.encode_array(px, CONFIG["maxval"], config, device="cpu")
    assert ran == [1]
    assert got == reference.encode(px, CONFIG["maxval"], CONFIG)


@pytest.mark.parametrize("preset", [P420, P422], ids=["P420", "P422"])
@pytest.mark.parametrize("bound", [64 * 10, 64 * 37, 1 << 28])
def test_p420_and_p422_answers_are_unchanged(monkeypatch, preset, bound):
    """Where chroma has at most as many blocks as luma, the chroma table
    never decides: the answer is the luma-only guard's on every shape."""
    monkeypatch.setattr(tod, "MAX_DEVICE_TABLE_SYMBOLS", bound)
    shapes = [(h, w) for h in (1, 7, 8, 15, 16, 17, 33, 48) for w in (1, 9, 16, 31, 64, 100)]
    if bound == 1 << 28:
        shapes += [(16368, 16384), (16384, 16384), (16384, 16400), *(s for s, _, _ in OTHER_CELLS)]
    assert [tod.one_dispatch_supported(h, w, preset) for h, w in shapes] == \
        [luma_only(h, w, preset) for h, w in shapes]


def test_the_gfx100_frame_stays_one_dispatch_at_the_real_bound():
    """1,589,952 luma blocks: the chroma table's worst case is
    2 x 64 x 1,589,952 = 203,513,856 symbols, under 2**28."""
    assert tod.MAX_DEVICE_TABLE_SYMBOLS == 1 << 28
    ph, pw = padded_size(*FRAME, P444)
    assert (ph // 8) * (pw // 8) == 1_589_952
    assert 2 * 64 * 1_589_952 < tod.MAX_DEVICE_TABLE_SYMBOLS
    assert tod.one_dispatch_supported(*FRAME, P444) is True
    assert tenc._use_one_dispatch(harness.encoder_config(dt, CONFIG), *FRAME) is True
    for shape, preset, supported in OTHER_CELLS:
        assert tod.one_dispatch_supported(*shape, preset) is supported


@pytest.mark.parametrize("shape", [(12000, 12000), (16368, 16384)])
def test_a_p444_frame_past_half_the_bound_takes_two_dispatch(shape):
    """134-268 Mpix at P444: the luma table is under 2**28, the shared
    chroma table's worst case over it."""
    assert luma_only(*shape, P444) is True
    assert tod.one_dispatch_supported(*shape, P444) is False


def jax_config():
    return dj.EncoderConfig(
        chroma_subsampling=dj.ChromaSubsamplingPreset(CONFIG["chroma_subsampling"]),
        quantization_preset=dj.QuantizationTablePreset[CONFIG["quantization_preset"]],
        quality=CONFIG["quality"],
        bits_per_channel=CONFIG["bits_per_channel"],
        dct_variant=dj.DCTVariant[CONFIG["dct_variant"]],
    )


@pytest.mark.parametrize("shape, seed", [((37, 61), 2**31 + 3), ((64, 96), 2**32 + 7),
                                         ((203, 317), 2**33 + 11)])
def test_port_reference_and_jax_agree_at_the_configurations_settings(shape, seed):
    """Byte for byte: the contract the cell judges by."""
    px = frames.frame_pixels(*shape, CONFIG["maxval"], seed)
    assert px.dtype == np.uint16 and int(px.max()) > 255
    got = dt.encode_array(px, CONFIG["maxval"], harness.encoder_config(dt, CONFIG), device="cpu")
    assert got == reference.encode(px, CONFIG["maxval"], CONFIG)
    assert got == dj.encode_array(px, CONFIG["maxval"], jax_config())


def test_the_ring_uploads_a_frame_in_37_bands_of_240_rows():
    """Rows of 11648 x 3 x 2 = 69,888 bytes; a 16 MiB slot holds 240."""
    shape = (*FRAME, 3)
    plan = programs.band_plan(shape, 2)
    assert 11648 * 3 * 2 * 240 <= programs.RING_SLOT_BYTES < 11648 * 3 * 2 * 241
    assert len(plan) == 37
    assert [stop - start for _, start, stop in plan] == [240] * 36 + [96]
    assert all(index == () for index, _, _ in plan)
    assert plan[0][1] == 0 and plan[-1][2] == FRAME[0]
    assert all(a[2] == b[1] for a, b in zip(plan, plan[1:]))
    assert FRAME[0] * FRAME[1] * 3 * 2 == 610_541_568 > programs.RING_MIN_BYTES
