"""PyTorch port, the route of images past the device table bound: the
benchmark's `bmng21600_p420` configuration, 21600x21600 Blue Marble tiles
(perfbench/configs/bmng21600_p420.json), which encode_array sends down the
two-dispatch encode because their luma table could see 466,560,000
symbols. On the CPU a small frame is put past the bound by patching
MAX_DEVICE_TABLE_SYMBOLS down: its bytes are held against the benchmark's
plain reference and the one-dispatch route's, and the two-dispatch host
tail's program spans are counted under torch.profiler."""

import json
from pathlib import Path

import pytest
import torch

import dmmt_jpeg_encoder_tpu_torch as dt
from dmmt_jpeg_encoder_tpu_torch import encoder as tenc
from dmmt_jpeg_encoder_tpu_torch import onedispatch as tod
from dmmt_jpeg_encoder_tpu_torch.bitstream.device_pack import exact_scan_bits
from dmmt_jpeg_encoder_tpu_torch.config import ChromaSubsamplingPreset
from perfbench import frames, harness, reference

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "perfbench" / "configs" / "bmng21600_p420.json").read_text())
# the two-dispatch tail's spans, in the order a request opens them
TAIL_SPANS = ("dmmt.hist_wait", "dmmt.host_tables", "dmmt.pack_wait", "dmmt.word_fetch",
              "dmmt.stuff")


@pytest.mark.parametrize("height, width, supported", [
    (CONFIG["height"], CONFIG["width"], False),  # the tile: 466,560,000 luma symbols
    (16384, 16384, False),                       # 2**28 exactly
    (16368, 16384, True),                        # one MCU row less
])
def test_the_device_table_bound_at_tile_sizes(height, width, supported):
    assert tod.one_dispatch_supported(height, width, ChromaSubsamplingPreset.P420) is supported


def tile_frame(shape, seed):
    (px,) = frames.frame_pool(*shape, 1, seed, "cpu", CONFIG["maxval"])
    return px


def past_the_bound(monkeypatch) -> list:
    """Every image of more than 10 luma blocks past the bound; the list
    records the two-dispatch first halves that run."""
    monkeypatch.setattr(tod, "MAX_DEVICE_TABLE_SYMBOLS", 64 * 10)
    ran = []
    real = tenc.run_device_pipeline
    monkeypatch.setattr(tenc, "run_device_pipeline", lambda *a, **k: ran.append(1) or real(*a, **k))
    return ran


@pytest.mark.parametrize("shape, seed", [((48, 64), 2**31 + 5), ((37, 53), 2**32 + 21)])
def test_tile_configuration_past_the_bound_matches_the_reference(monkeypatch, shape, seed):
    """encode_array at the configuration's settings, routed by the bound
    alone, gives the plain reference's bytes and the one-dispatch route's."""
    px = tile_frame(shape, seed)
    config = harness.encoder_config(dt, CONFIG)
    one_dispatch = dt.encode_array(px, CONFIG["maxval"], config, device="cpu")
    ran = past_the_bound(monkeypatch)
    monkeypatch.setattr(tenc, "start_one_dispatch", lambda *a, **k: pytest.fail("one dispatch ran"))
    two_dispatch = dt.encode_array(px, CONFIG["maxval"], config, device="cpu")
    assert ran == [1]
    assert two_dispatch == one_dispatch == reference.encode(px, CONFIG["maxval"], CONFIG)


def test_two_dispatch_tail_spans_once_each_in_order(monkeypatch):
    px = tile_frame((48, 64), 2**31 + 9)
    config = harness.encoder_config(dt, CONFIG)
    want = dt.encode_array(px, CONFIG["maxval"], config, device="cpu")
    past_the_bound(monkeypatch)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = dt.encode_array(px, CONFIG["maxval"], config, device="cpu")
    assert got == want
    spans = sorted((e.time_range.start, e.name) for e in prof.events()
                   if e.name.startswith("dmmt."))
    names = [name for _, name in spans]
    assert {name: names.count(name) for name in TAIL_SPANS} == dict.fromkeys(TAIL_SPANS, 1)
    assert [name for name in names if name in TAIL_SPANS] == list(TAIL_SPANS)
    assert names[-1] == "dmmt.container"


def test_tables_from_histograms_carry_the_exact_scan_length():
    """from_histograms' scan_bits is exact_scan_bits of its histograms: the
    stream length the device pack is given."""
    px = tile_frame((48, 64), 2**31 + 13)
    config = harness.encoder_config(dt, CONFIG)
    luma_q, chroma_q = tenc.quantization_table_pair(config.quantization_preset, config.quality)
    result = tenc.run_device_pipeline(px, CONFIG["maxval"], config, luma_q, chroma_q, device="cpu")
    tables = tenc.HuffmanTables.from_histograms(result)
    hists = (result.luma_dc_hist, result.luma_ac_hist, result.chroma_dc_hist,
             result.chroma_ac_hist)
    assert tables.flat() is tables.flat()
    assert tables.scan_bits == exact_scan_bits(hists, *tables.flat())
    scan = tenc.pack_scan(result, tables, config)
    unstuffed = len(scan) - scan.count(b"\xff\x00")
    assert unstuffed == (tables.scan_bits + 7) // 8
