"""PyTorch port, the two-dispatch encode: the histogram, lookup and
emission-pack kernels' plain versions and the staged pack against the JAX
package, then whole-encode bytes of every two-dispatch route against the
JAX package's encode_array and CLI on the CPU, exactly (every output is an
integer).

The plain versions are held against the JAX Pallas kernels in interpret
mode where their contract differs from the JAX CPU fallbacks (symbols out
of range), and against the fallbacks elsewhere."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dmmt_jpeg_encoder_tpu as dj
import dmmt_jpeg_encoder_tpu_torch as dt
from dmmt_jpeg_encoder_tpu import cli as jax_cli
from dmmt_jpeg_encoder_tpu.bitstream import device_pack as jpack
from dmmt_jpeg_encoder_tpu.bitstream.pallas_pack import pack_words_capacity, pallas_pack_words
from dmmt_jpeg_encoder_tpu.io.ppm import write_ppm
from dmmt_jpeg_encoder_tpu.ops.pallas_histogram import pallas_histogram, pallas_histogram_grouped
from dmmt_jpeg_encoder_tpu.ops.pallas_lookup import pallas_table_lookup, pallas_table_lookup_grouped
from dmmt_jpeg_encoder_tpu_torch import cli as port_cli
from dmmt_jpeg_encoder_tpu_torch import encoder as tenc
from dmmt_jpeg_encoder_tpu_torch import onedispatch as tod
from dmmt_jpeg_encoder_tpu_torch.bitstream import device_pack as tpack
from dmmt_jpeg_encoder_tpu_torch.bitstream.emission_pack import pack_emission_words
from dmmt_jpeg_encoder_tpu_torch.config import config_from_jax
from dmmt_jpeg_encoder_tpu_torch.entropy import categorize as tcat
from dmmt_jpeg_encoder_tpu_torch.huffman.canonical import flat_code_arrays
from dmmt_jpeg_encoder_tpu_torch.huffman.spec import code_lengths_from_histogram
from dmmt_jpeg_encoder_tpu_torch.kernels import build
from dmmt_jpeg_encoder_tpu_torch.ops.histogram import histogram, histogram_grouped
from dmmt_jpeg_encoder_tpu_torch.ops.lookup import table_lookup, table_lookup_grouped
from torch_port_fixtures import random_blocks


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("DMMT_PALLAS_INTERPRET", "1")


# --- the histogram kernel's plain version ------------------------------------


def test_histogram_matches_pallas_kernel(interpret):
    """Weight-0 entries and symbols outside [0, n_bins) count nowhere."""
    rng = np.random.default_rng(1)
    for n_bins in (16, 256):
        sym = rng.integers(-5, n_bins + 5, 9000).astype(np.int32)
        w = (rng.random(9000) < 0.7).astype(np.float32)
        want = np.asarray(pallas_histogram(jnp.asarray(sym), jnp.asarray(w), n_bins))
        got = histogram(torch.from_numpy(sym), torch.from_numpy(w.astype(np.int32)), n_bins)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_histogram_grouped_matches_pallas_kernel(interpret):
    rng = np.random.default_rng(2)
    sym = rng.integers(-3, 260, (3, 5000)).astype(np.int32)
    w = (rng.random((3, 5000)) < 0.5).astype(np.float32)
    want = np.asarray(pallas_histogram_grouped(jnp.asarray(sym), jnp.asarray(w), 256))
    got = histogram_grouped(torch.from_numpy(sym), torch.from_numpy(w).to(torch.int32), 256)
    np.testing.assert_array_equal(got.numpy(), want)


def test_histogram_grouped_matches_jax_fallback():
    """In range and with integer weights > 1 the JAX scatter fallback is the
    reference too."""
    rng = np.random.default_rng(3)
    sym = rng.integers(0, 16, (4, 3000)).astype(np.int32)
    w = rng.integers(0, 4, (4, 3000)).astype(np.int32)
    want = np.asarray(pallas_histogram_grouped(jnp.asarray(sym), jnp.asarray(w, jnp.float32), 16))
    got = histogram_grouped(torch.from_numpy(sym), torch.from_numpy(w), 16)
    np.testing.assert_array_equal(got.numpy(), want)


# --- the lookup kernel's plain version ---------------------------------------


def test_table_lookup_matches_pallas_kernel(interpret):
    """A symbol that matches no entry gives 0, as the Pallas kernel's sweep."""
    rng = np.random.default_rng(4)
    table = rng.integers(0, 1 << 24, 512).astype(np.uint32)
    sym = rng.integers(-4, 520, (300, 63)).astype(np.int32)
    want = np.asarray(pallas_table_lookup(jnp.asarray(sym), jnp.asarray(table)))
    got = table_lookup(torch.from_numpy(sym), torch.from_numpy(table.astype(np.int32)))
    assert got.shape == sym.shape and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))


@pytest.mark.parametrize("width", [32, 512])
def test_table_lookup_grouped_matches_jax(width):
    rng = np.random.default_rng(width)
    tables = rng.integers(0, 1 << 24, (3, width)).astype(np.uint32)
    sym = rng.integers(0, width, (3, 4000)).astype(np.int32)
    want = np.asarray(pallas_table_lookup_grouped(jnp.asarray(sym), jnp.asarray(tables)))
    got = table_lookup_grouped(torch.from_numpy(sym), torch.from_numpy(tables.astype(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))


def test_kernel_wrappers_refuse_bad_input():
    s = torch.zeros((2, 10), dtype=torch.int32)
    with pytest.raises(ValueError):
        histogram_grouped(s, s[:1], 16)
    with pytest.raises(ValueError):
        histogram_grouped(s, s, 257)
    with pytest.raises(ValueError):
        histogram_grouped(s.to("meta"), s.to("meta"), 16)
    with pytest.raises(ValueError):
        table_lookup_grouped(s, torch.zeros((2, 513), dtype=torch.int32))
    with pytest.raises(ValueError):
        table_lookup_grouped(s.to("meta"), torch.zeros((2, 4), dtype=torch.int32, device="meta"))
    e = torch.zeros((3, 68), dtype=torch.int32)
    with pytest.raises(ValueError):
        pack_emission_words(e, e, e, torch.zeros(2, dtype=torch.int32), 8)
    with pytest.raises(ValueError):
        pack_emission_words(e, e, e, torch.zeros(3, dtype=torch.int32), 8,
                            boff=torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError):
        pack_emission_words(*(x.to("meta") for x in (e, e, e)),
                            torch.zeros(3, dtype=torch.int32, device="meta"), 8)


# --- block emissions and the emission pack -----------------------------------


def _tables_for(blocks: np.ndarray) -> tuple:
    """(flat luma DC, luma AC) tables of blocks' own histograms, used for
    both table sets."""
    dc, ac = (h.numpy() for h in tcat.symbol_histograms(torch.from_numpy(blocks)))
    return tuple(flat_code_arrays(code_lengths_from_histogram(h)) for h in (dc, ac))


def _combined(tables: list[tuple]) -> tuple[np.ndarray, np.ndarray]:
    """Per image (dc, ac) flat tables -> uint32 dc_comb [G * 32] and ac_comb
    [G * 512], each image's table set twice (luma, chroma)."""
    dc = np.concatenate([jpack.combine_tables(np.asarray(d[0])[:16], np.asarray(d[1])[:16])
                         for d, _ in tables for _ in range(2)])
    ac = np.concatenate([jpack.combine_tables(np.asarray(a[0]), np.asarray(a[1]))
                         for _, a in tables for _ in range(2)])
    return dc, ac


jax_emissions = jax.jit(jpack.block_emissions, static_argnames="groups")


@pytest.mark.parametrize("groups", [1, 3])
def test_block_emissions_match_jax(groups, monkeypatch):
    """Per-image tables with groups > 1; every lookup the emissions make is
    in range, so the JAX gather fallback and the kernel's 0 agree."""
    n = 150
    images = [random_blocks(60 + g, n=n) for g in range(groups)]
    tables = [_tables_for(b) for b in images]
    dc_comb, ac_comb = _combined(tables)
    blocks = np.concatenate(images)
    idx = (np.arange(groups)[:, None] * 2 + (np.arange(n) % 3 == 2)).reshape(-1).astype(np.int32)
    want = jax_emissions(jnp.asarray(blocks), jnp.asarray(idx), jnp.asarray(dc_comb),
                         jnp.asarray(ac_comb), groups=groups)
    dc_t, ac_t = (torch.from_numpy(x.astype(np.int32)) for x in (dc_comb, ac_comb))
    in_range = []

    def checked(symbols, tables):
        in_range.append(bool(((symbols >= 0) & (symbols < tables.shape[1])).all()))
        return table_lookup_grouped(symbols, tables)

    monkeypatch.setattr(tpack, "table_lookup_grouped", checked)
    got = tpack.block_emissions(torch.from_numpy(blocks), torch.from_numpy(idx), dc_t, ac_t,
                                groups=groups)
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int32))
    assert in_range == [True, True]  # the DC and the AC lookup


def _emissions(seed: int, n: int):
    blocks = random_blocks(seed, n=n)
    dc_comb, ac_comb = _combined([_tables_for(blocks)])
    return tuple(np.asarray(x) for x in jax_emissions(
        jnp.asarray(blocks), jnp.zeros(n, jnp.int32), jnp.asarray(dc_comb), jnp.asarray(ac_comb)))


@pytest.mark.parametrize("short", [False, True])
def test_pack_emission_words_matches_jax_pack_to_words(short):
    """`short`: a word buffer below the stream's length drops what falls
    past it, as the JAX scatter does."""
    values, lens, offs, bits = _emissions(70, 200)
    n_words = int(bits.sum()) // 32 // 2 if short else int(bits.sum()) // 32 + 3
    jw, jbits = jax.jit(jpack.pack_to_words, static_argnums=4)(
        *(jnp.asarray(x) for x in (values, lens, offs, bits)), n_words)
    words, total = pack_emission_words(
        *(torch.from_numpy(x.astype(np.int32)) for x in (values, lens, offs, bits)), n_words)
    assert words.dtype == torch.int32 and int(total) == int(jbits)
    np.testing.assert_array_equal(words.numpy().view(np.uint32), np.asarray(jw))


def test_pack_emission_words_with_boff_matches_pallas_kernel(interpret):
    """Word-aligned per-segment bases, as the fused batch places images,
    against the Pallas fragment + merge kernels in interpret mode."""
    values, lens, offs, bits = _emissions(71, 96)
    seg = np.repeat(np.arange(3), 32)
    in_seg = np.concatenate([np.cumsum(b) - b for b in np.split(bits.astype(np.int64), 3)])
    seg_words = [(int(b.sum()) + 31) // 32 for b in np.split(bits, 3)]
    word_off = np.concatenate([[0], np.cumsum(seg_words)[:-1]]) + 5
    boff = word_off[seg] * 32 + in_seg
    total_words = int(word_off[-1]) + seg_words[-1]
    jw, _ = pallas_pack_words(*(jnp.asarray(x) for x in (values, lens, offs, bits)),
                              pack_words_capacity(total_words + 2),
                              boff=jnp.asarray(boff.astype(np.int32)))
    words, _ = pack_emission_words(
        *(torch.from_numpy(x.astype(np.int32)) for x in (values, lens, offs, bits)),
        total_words + 2, boff=torch.from_numpy(boff))
    np.testing.assert_array_equal(words.numpy().view(np.uint32),
                                  np.asarray(jw)[: total_words + 2])
    assert not words[:5].any()


@pytest.mark.parametrize("n_luma,n_chroma,lpm", [(40, 10, 4), (18, 9, 2), (7, 7, 1), (9, 0, 1)])
def test_scan_order_permutation_matches_jax(n_luma, n_chroma, lpm):
    for a, b in zip(tpack.scan_order_permutation(n_luma, n_chroma, lpm),
                    jpack.scan_order_permutation(n_luma, n_chroma, lpm)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_luma,n_chroma,lpm", [(40, 10, 4), (18, 9, 2), (7, 7, 1)])
def test_chroma_index_matches_jax_scan_order(n_luma, n_chroma, lpm):
    """The pack's device-made chroma marks equal the JAX package's is_luma."""
    _, is_luma = jpack.scan_order_permutation(n_luma, n_chroma, lpm)
    got = tpack.chroma_index(n_luma + 2 * n_chroma, lpm + 2, lpm, "cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), (~is_luma).astype(np.int32))


def test_device_pack_scan_checks_the_bit_count(monkeypatch):
    """DMMT_CHECK_BITS: a predicted length that is not what was packed
    raises, on both pack routes."""
    monkeypatch.setenv("DMMT_CHECK_BITS", "1")
    blocks = torch.from_numpy(random_blocks(72, n=60))
    luma, cb, cr = blocks[:40], blocks[40:50], blocks[50:]
    lt, ct = _tables_for(luma.numpy()), _tables_for(np.concatenate([cb, cr]))
    for staged in ("", "1"):
        monkeypatch.setenv("DMMT_NO_FUSED_PACK", staged)
        args = (luma, cb, cr, 4, lt[0], lt[1], ct[0], ct[1])
        hists = [*tcat.symbol_histograms(luma), *tcat.symbol_histograms(torch.cat([cb, cr]))]
        bits = tpack.exact_scan_bits(tuple(h.numpy() for h in hists), lt[0], lt[1], ct[0], ct[1])
        assert tpack.device_pack_scan(*args, known_bits=bits)
        with pytest.raises(AssertionError, match="predict"):
            tpack.device_pack_scan(*args, known_bits=bits + 1)


# --- whole-encode bytes --------------------------------------------------------


def _image(seed, shape, maxval=255):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0 : shape[0], 0 : shape[1]]
    base = 30 + (xx * 170) // max(shape[1] - 1, 1) + (yy * 40) // max(shape[0] - 1, 1)
    px = np.clip(base[..., None] + rng.integers(-25, 26, (*shape, 3)), 0, 255)
    if maxval > 255:
        return (px * 16 + rng.integers(0, 16, (*shape, 3))).astype(np.uint16)
    return px.astype(np.uint8)


_JAX_BYTES: dict = {}


def _want(px, maxval, cfg):
    key = (px.tobytes(), px.shape, maxval, cfg)
    if key not in _JAX_BYTES:
        _JAX_BYTES[key] = dj.encode_array(px, maxval, cfg)
    return _JAX_BYTES[key]


def _jax_cfg(preset, quality=None):
    return dj.EncoderConfig(chroma_subsampling=dj.ChromaSubsamplingPreset(preset), quality=quality)


ENCODE_CASES = [
    ("P420", (7, 17), 255, None),
    ("P422", (7, 17), 255, 75),
    ("P444", (7, 17), 255, None),
    ("P420", (37, 61), 4095, None),
    ("P422", (37, 61), 255, 75),
    ("P444", (37, 61), 4095, 75),
]


@pytest.mark.parametrize("preset,shape,maxval,quality", ENCODE_CASES)
@pytest.mark.parametrize("route", ["one_dispatch_off", "host_native", "staged", "hist_pallas",
                                   "hist_matmul"])
def test_two_dispatch_bytes_match_jax(monkeypatch, route, preset, shape, maxval, quality):
    px = _image(shape[0] + maxval + (quality or 0), shape, maxval)
    cfg = _jax_cfg(preset, quality)
    port = config_from_jax(cfg)
    if route == "host_native":
        port = dataclasses.replace(port, scan_backend="host")
    else:
        port = dataclasses.replace(port, one_dispatch="off")
    env = {"staged": ("DMMT_NO_FUSED_PACK", "1"), "hist_pallas": ("DMMT_HIST", "pallas"),
           "hist_matmul": ("DMMT_HIST", "matmul")}
    if route in env:
        monkeypatch.setenv(*env[route])
    assert dt.encode_array(px, maxval, port, device="cpu") == _want(px, maxval, cfg)


@pytest.mark.parametrize("preset", ["P420", "P422", "P444"])
def test_host_python_packer_bytes_match_jax(preset):
    """use_native=False, the Python packer (8x8 only: it is slow)."""
    px = _image(8, (8, 8))
    cfg = _jax_cfg(preset, 75)
    port = dataclasses.replace(config_from_jax(cfg), scan_backend="host")
    want = _want(px, 255, cfg)
    assert dt.encode_array(px, 255, port, use_native=False, device="cpu") == want
    assert dj.encode_array(px, 255, cfg, use_native=False) == want


@pytest.mark.parametrize("mode,want_calls", [("pallas", 4), ("matmul", 4), ("fused", 0)])
def test_dmmt_hist_selects_the_histogram_kernel_on_the_one_dispatch_path(
        monkeypatch, mode, want_calls):
    """DMMT_HIST selects the histogram kernel wherever symbol_histograms
    runs, the one-dispatch path included, as in the JAX package: DC and AC
    for luma and for Cb+Cr."""
    from dmmt_jpeg_encoder_tpu_torch.ops import histogram as thist

    calls = []
    real = thist.histogram
    monkeypatch.setattr(thist, "histogram", lambda *a: calls.append(1) or real(*a))
    monkeypatch.setenv("DMMT_HIST", mode)
    px = _image(9, (24, 40))
    cfg = _jax_cfg("P420")
    assert dt.encode_array(px, 255, config_from_jax(cfg), device="cpu") == _want(px, 255, cfg)
    assert len(calls) == want_calls


@pytest.mark.parametrize("batch", [False, True])
def test_images_past_the_device_table_bound_take_two_dispatch(monkeypatch, batch):
    """A small MAX_DEVICE_TABLE_SYMBOLS puts the image past the bound:
    encode_array and encode_batch route it to the two-dispatch path instead
    of raising; the one-dispatch start functions still refuse it."""
    monkeypatch.setattr(tod, "MAX_DEVICE_TABLE_SYMBOLS", 64 * 10)
    ran = []
    real = tenc.run_device_pipeline
    monkeypatch.setattr(tenc, "run_device_pipeline", lambda *a, **k: ran.append(1) or real(*a, **k))
    px = _image(10, (24, 40))
    cfg = _jax_cfg("P422", 75)
    port = config_from_jax(cfg)
    if batch:
        images = [px, _image(11, (24, 40))]
        assert dt.encode_batch(images, 255, port, device="cpu") == \
            [_want(p, 255, cfg) for p in images]
        assert len(ran) == 2
    else:
        assert dt.encode_array(px, 255, port, device="cpu") == _want(px, 255, cfg)
        assert len(ran) == 1
    lq, cq = np.ones(64, np.uint8), np.ones(64, np.uint8)
    with pytest.raises(NotImplementedError, match="two-dispatch"):
        tod.start_one_dispatch(px, 255, port, lq, cq, device="cpu")


@pytest.mark.parametrize("batch", [False, True])
def test_dmmt_no_onedispatch_takes_two_dispatch(monkeypatch, batch):
    """DMMT_NO_ONEDISPATCH=1 sends encode_array and encode_batch down the
    two-dispatch path, as the JAX package's _use_one_dispatch reads it;
    the bytes stay the JAX package's."""
    monkeypatch.setenv("DMMT_NO_ONEDISPATCH", "1")
    ran = []
    real = tenc.run_device_pipeline
    monkeypatch.setattr(tenc, "run_device_pipeline", lambda *a, **k: ran.append(1) or real(*a, **k))
    monkeypatch.setattr(tenc, "start_one_dispatch", lambda *a, **k: pytest.fail("one dispatch ran"))
    cfg = _jax_cfg("P420", 75)
    images = [_image(18 + i, (21, 30)) for i in range(3)]
    if batch:
        assert tenc.slab_depth(images, config_from_jax(cfg)) == 1
        assert dt.encode_batch(images, 255, config_from_jax(cfg), device="cpu") == \
            [_want(p, 255, cfg) for p in images]
        assert len(ran) == 3
    else:
        assert dt.encode_array(images[0], 255, config_from_jax(cfg), device="cpu") == \
            _want(images[0], 255, cfg)
        assert len(ran) == 1


def test_encode_batch_two_dispatch_per_image(monkeypatch):
    """one_dispatch="off" and the host backend run encode_batch per image
    through the two-dispatch path (the JAX package's "std" arm)."""
    images = [_image(12 + i, (21, 30)) for i in range(3)] + [_image(15, (7, 17))]
    cfg = _jax_cfg("P420", 75)
    want = [_want(p, 255, cfg) for p in images]
    for kw in (dict(one_dispatch="off"), dict(scan_backend="host")):
        port = dataclasses.replace(config_from_jax(cfg), **kw)
        assert tenc.slab_depth(images[:3], port) == 1
        assert dt.encode_batch(images, 255, port, device="cpu") == want


@pytest.mark.parametrize("flags", [["--one-dispatch", "off"], ["--scan-backend", "host"],
                                   ["--scan-backend", "host", "--no-native"],
                                   ["--one-dispatch", "off", "-p", "P444", "--quality", "75"]])
def test_cli_two_dispatch_flags_match_jax_cli(tmp_path, flags):
    src = tmp_path / "in.ppm"
    write_ppm(src, _image(16, (8, 16) if "--no-native" in flags else (29, 45)))
    a, b = tmp_path / "jax.jpg", tmp_path / "port.jpg"
    assert jax_cli.main([str(src), str(a), *flags]) == 0
    assert port_cli.main([str(src), str(b), *flags, "--device", "cpu"]) == 0
    assert b.read_bytes() == a.read_bytes()


def test_launch_counters_cover_the_new_kernels():
    assert {"histogram", "table_lookup", "pack_emissions"} <= set(build.LAUNCHES)
    for name in ("dmmt_histogram_grouped", "dmmt_table_lookup_grouped", "dmmt_pack_emissions"):
        assert name in build._SIGNATURES


def test_cuda_two_dispatch_kernels_match_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check on the GPU")
    rng = np.random.default_rng(17)
    sym = torch.from_numpy(rng.integers(-3, 260, (3, 7000)).astype(np.int32))
    w = torch.from_numpy(rng.integers(0, 2, (3, 7000)).astype(np.int32))
    assert torch.equal(histogram_grouped(sym.cuda(), w.cuda(), 256).cpu(),
                       histogram_grouped(sym, w, 256))
    tab = torch.from_numpy(rng.integers(0, 1 << 24, (3, 512)).astype(np.int32))
    assert torch.equal(table_lookup_grouped(sym.cuda(), tab.cuda()).cpu(),
                       table_lookup_grouped(sym, tab))
    em = [torch.from_numpy(x.astype(np.int32)) for x in _emissions(73, 300)]
    for got, want in zip(pack_emission_words(*(x.cuda() for x in em), 900),
                         pack_emission_words(*em, 900)):
        assert torch.equal(got.cpu(), want)

