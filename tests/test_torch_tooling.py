"""PyTorch port, the tooling modules: the Huffman tree and canonical-code
decoder (huffman/tree.py, huffman/decoder.py), the baseline JPEG parser
and decoder (debug/jpeg_decoder.py), the profiling helpers
(utils/profiling.py) and the test-facing `ops/dct.idct2d` and
`ops/geometry.subsample_generalized`.

Each is held against its JAX package counterpart on the same inputs. The
tree, the decoders and the subsample are exact; idct2d is float32 with
another summation order than XLA's einsum, held to 1e-3 (its outputs
reach ~2000, where a float32 ulp is 1.2e-4). The 4K golden's decode
measures the PSNR floor that chip_smoke.py holds the card's JPEG to."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dmmt_jpeg_encoder_tpu as dj
import dmmt_jpeg_encoder_tpu_torch as dt
from dmmt_jpeg_encoder_tpu.config import SubsamplingMethod as JaxMethod
from dmmt_jpeg_encoder_tpu.debug import jpeg_decoder as jdec
from dmmt_jpeg_encoder_tpu.huffman import HuffmanDecoder as JaxHuffmanDecoder
from dmmt_jpeg_encoder_tpu.huffman import tree as jtree
from dmmt_jpeg_encoder_tpu.ops import dct as jdct
from dmmt_jpeg_encoder_tpu.ops import geometry as jgeom
from dmmt_jpeg_encoder_tpu.utils import profiling as jprof
from dmmt_jpeg_encoder_tpu_torch.config import SubsamplingMethod
from dmmt_jpeg_encoder_tpu_torch.debug import jpeg_decoder as pdec
from dmmt_jpeg_encoder_tpu_torch.errors import HuffmanError
from dmmt_jpeg_encoder_tpu_torch.huffman import HuffmanDecoder
from dmmt_jpeg_encoder_tpu_torch.huffman import tree as ptree
from dmmt_jpeg_encoder_tpu_torch.huffman.canonical import canonical_codes
from dmmt_jpeg_encoder_tpu_torch.huffman.spec import code_lengths_from_histogram
from dmmt_jpeg_encoder_tpu_torch.ops import dct as pdct
from dmmt_jpeg_encoder_tpu_torch.ops import geometry as pgeom
from dmmt_jpeg_encoder_tpu_torch.utils import profiling as pprof
from torch_port_fixtures import (
    DECODE_PSNR_FLOOR_4K,
    FIXTURES,
    SMALL_FIXTURES,
    fixture_pixels,
    load_goldens,
    psnr,
    sha256,
)

EVEN = [(1, 17), (2, 3), (3, 12), (4, 3), (5, 18), (6, 12)]
ODD = [(1, 17), (2, 3), (3, 12), (4, 3), (5, 18), (6, 12), (7, 13)]
SKEWED = [(s, f) for s, f in zip(range(40, 0, -1), np.random.default_rng(3).integers(1, 1 << 12, 40))]
TREE_CASES = [(EVEN, 10), (ODD, 10), (ODD, 4), (SKEWED, 15), (SKEWED, 7),
              ([(1, 4), (2, 4), (3, 6), (4, 6), (5, 7), (6, 9)], 10)]


def _nodes(tree):
    return [(n.frequency, n.index, n.kind, n.symbol, n.left, n.right) for n in tree.nodes]


@pytest.mark.parametrize("replace", [False, True])
@pytest.mark.parametrize("pairs,limit", TREE_CASES)
def test_huffman_tree_matches_jax(pairs, limit, replace):
    pairs = [(int(s), int(f)) for s, f in pairs]
    port, ref = ptree.HuffmanTree(pairs, limit=limit), jtree.HuffmanTree(pairs, limit=limit)
    if replace:
        port.replace_onestar()
        ref.replace_onestar()
    assert _nodes(port) == _nodes(ref)
    assert (port.root_index, port.leaf_count, port.least_frequent_symbol_node_index) == (
        ref.root_index, ref.leaf_count, ref.least_frequent_symbol_node_index)
    assert str(port) == str(ref)
    data = np.random.default_rng(limit).integers(0, 256, 24, dtype=np.uint8).tobytes()
    assert port.decode_sequence(data) == ref.decode_sequence(data)


def test_huffman_tree_reference_decode_and_display():
    """tree.rs test_coder_decode's byte sequence, and the OneStar box."""
    tree = ptree.HuffmanTree(ODD, limit=10)
    tree.replace_onestar()
    data = bytes([0b01110111, 0b10111101, 0b00001110, 0b11100100])
    assert tree.decode_sequence(data)[:9] == [1, 3, 2, 2, 7, 5, 4, 4, 1]
    assert "╔╝" in str(tree) and all(f"(s:{s},f:{f})" in str(tree) for s, f in ODD)
    assert (ptree.LEAF, ptree.ONESTAR, ptree.INNER) == (jtree.LEAF, jtree.ONESTAR, jtree.INNER)


@pytest.mark.parametrize("n_symbols,seed", [(1, 0), (2, 1), (12, 2), (162, 3), (256, 4)])
def test_huffman_decoder_matches_jax(n_symbols, seed):
    """Canonical codes of a histogram's code lengths; a seeded symbol
    sequence packed MSB first decodes to itself with both decoders."""
    rng = np.random.default_rng(seed)
    hist = np.zeros(256, np.int64)
    hist[rng.choice(256, n_symbols, replace=False)] = rng.integers(1, 5000, n_symbols)
    lengths = code_lengths_from_histogram(hist)
    codes = canonical_codes(lengths)
    symbols = [int(s) for s in rng.choice(np.flatnonzero(hist), 300)]
    bits = "".join(format(codes[s].bits, f"0{codes[s].length}b") for s in symbols)
    bits += "1" * (-len(bits) % 8)
    data = int(bits, 2).to_bytes(len(bits) // 8, "big")
    port = HuffmanDecoder(lengths)
    assert port.decode_sequence(data, len(symbols)) == symbols
    assert JaxHuffmanDecoder(lengths).decode_sequence(data, len(symbols)) == symbols
    with pytest.raises(HuffmanError):
        port.decode_sequence(data, len(symbols) + 8 * len(data))


def _fixture_jpeg(name: str) -> bytes:
    """The port's CPU JPEG of a fixture, held to its JAX golden."""
    f = FIXTURES[name]
    cfg = dt.EncoderConfig(chroma_subsampling=dt.ChromaSubsamplingPreset(f["preset"]),
                           quality=f["quality"])
    jpeg = dt.encode_array(fixture_pixels(name), f["maxval"], cfg, device="cpu")
    assert sha256(jpeg) == load_goldens()[name]["jpeg_sha256"]
    return jpeg


@pytest.mark.parametrize("name", SMALL_FIXTURES)
def test_parse_and_decode_match_jax(name):
    jpeg = _fixture_jpeg(name)
    port, ref = pdec.parse_jpeg(jpeg), jdec.parse_jpeg(jpeg)
    assert [s[0] for s in port.segments] == ["SOI", "APP0", "DQT", "DQT", "SOF0",
                                             "DHT", "DHT", "DHT", "DHT", "SOS", "EOI"]
    assert port.segments == ref.segments
    assert (port.width, port.height, port.precision) == (ref.width, ref.height, ref.precision)
    assert port.quant.keys() == ref.quant.keys()
    assert all(np.array_equal(port.quant[k], ref.quant[k]) for k in ref.quant)
    assert port.huffman == ref.huffman
    assert [vars(c) for c in port.components] == [vars(c) for c in ref.components]
    assert port.scan_data == ref.scan_data
    got, want = pdec.decode_jpeg(jpeg), jdec.decode_jpeg(jpeg)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    f = FIXTURES[name]
    assert got.shape == (f["height"], f["width"], 3)
    assert psnr(got, fixture_pixels(name), f["maxval"]) > 28


@pytest.mark.parametrize("preset,qtable,floor", [("P420", "Specification", 28),
                                                 ("P422", "Specification", 28),
                                                 ("P444", "Specification", 28),
                                                 ("P444", "Flat", 35)])
def test_decode_round_trip_matches_jax(preset, qtable, floor):
    """test_jpeg_decoder.py's round trips: a 40x56 gradient, decoded by
    both decoders (the port's encode bytes equal the JAX package's:
    test_torch_e2e.py)."""
    yy, xx = np.mgrid[0:40, 0:56]
    px = np.stack([xx * 255 // 55, yy * 255 // 39, (xx + yy) * 255 // 94], -1).astype(np.uint8)
    cfg = dt.EncoderConfig(chroma_subsampling=dt.ChromaSubsamplingPreset(preset),
                           quantization_preset=dt.QuantizationTablePreset(qtable))
    jpeg = dt.encode_array(px, 255, cfg, device="cpu")
    got = pdec.decode_jpeg(jpeg)
    np.testing.assert_array_equal(got, jdec.decode_jpeg(jpeg))
    assert psnr(got, px) > floor


def test_decode_4k_golden_psnr_floor(monkeypatch):
    """The floor chip_smoke.py holds the card's 4K JPEG to: the port's CPU
    JPEG of the 4K fixture (its golden's bytes, so the host bit-count
    cross-check is left off) decodes to 32.627 dB."""
    monkeypatch.delenv("DMMT_CHECK_BITS", raising=False)
    jpeg = _fixture_jpeg("4k_p420")
    value = psnr(pdec.decode_jpeg(jpeg), fixture_pixels("4k_p420"))
    assert DECODE_PSNR_FLOOR_4K <= value < DECODE_PSNR_FLOOR_4K + 0.05, value


def test_stage_timer_matches_jax():
    port, ref = pprof.StageTimer(), jprof.StageTimer()
    for t in (port, ref):
        assert t.lap("a") >= 0.0 and t.lap("b") >= 0.0
        t.laps = [("phase 1", 0.0123), ("pack", 0.00456)]
    assert port.report() == ref.report() == "phase 1: 12.3 ms | pack: 4.6 ms | total: 16.9 ms"
    with pprof.stage_timer() as t:
        np.dot(np.ones((8, 8)), np.ones((8, 8)))
        t.lap("dot")
    assert [name for name, _ in t.laps] == ["dot"]


def test_trace_writes_chrome_trace(tmp_path):
    with pprof.trace(str(tmp_path / "trace")):
        torch.ones(8, 8) @ torch.ones(8, 8)
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any("matmul" in e.get("name", "") or "mm" in e.get("name", "") for e in events)


def test_trace_is_a_no_op_when_the_profiler_cannot_start(tmp_path, monkeypatch):
    def refuse(self):
        raise RuntimeError("profiler busy")

    monkeypatch.setattr(torch.profiler.profile, "start", refuse)
    with pprof.trace(str(tmp_path / "trace")):
        x = torch.ones(3).sum()
    assert float(x) == 3.0 and not (tmp_path / "trace").exists()


@pytest.mark.parametrize("n", [1, 16, 129])
def test_idct2d_matches_jax_and_round_trips(n):
    rng = np.random.default_rng(n)
    coeffs = rng.integers(-1024, 1024, (n, 8, 8)).astype(np.float32)
    got = pdct.idct2d(torch.from_numpy(coeffs)).numpy()
    np.testing.assert_allclose(got, np.asarray(jdct.idct2d(jnp.asarray(coeffs))), rtol=0, atol=1e-3)
    blocks = torch.from_numpy(rng.integers(-128, 128, (n, 8, 8)).astype(np.float32))
    np.testing.assert_allclose(pdct.idct2d(pdct.dct2d(blocks)).numpy(), blocks.numpy(), atol=2e-3)


SUBSAMPLE_CASES = [((12, 16), 2, 2), ((13, 17), 2, 2), ((15, 14), 3, 2), ((9, 10), 1, 3),
                   ((7, 7), 4, 4), ((8, 8), 1, 1), ((13, 17), 2, 3), ((4, 5), 3, 3)]


@pytest.mark.parametrize("method", ["AVERAGE", "SKIP"])
@pytest.mark.parametrize("shape,hr,vr", SUBSAMPLE_CASES)
def test_subsample_generalized_matches_jax(shape, hr, vr, method):
    chan = (np.random.default_rng(hr * 10 + vr).integers(0, 1 << 16, shape) / 65536).astype(np.float32)
    got = pgeom.subsample_generalized(torch.from_numpy(chan), hr, vr, SubsamplingMethod[method])
    want = jgeom.subsample_generalized(jnp.asarray(chan), hr, vr, JaxMethod[method])
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_subsample_generalized_matches_jax_preset_path():
    chan = (np.random.default_rng(7).integers(0, 1 << 16, (32, 48)) / 65536).astype(np.float32)
    for preset in dj.ChromaSubsamplingPreset:
        got = pgeom.subsample_generalized(torch.from_numpy(chan), preset.horizontal_rate,
                                          preset.vertical_rate,
                                          SubsamplingMethod(preset.method.value))
        np.testing.assert_array_equal(got.numpy(), np.asarray(jgeom.subsample(jnp.asarray(chan), preset)))
    with pytest.raises(ValueError, match="rates"):
        pgeom.subsample_generalized(torch.from_numpy(chan), 0, 1, SubsamplingMethod.AVERAGE)
