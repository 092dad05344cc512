"""PyTorch port, the edge shapes of the tilings of the block DCT kernel
(csrc/block_dct.cu) and the table lookup kernel (csrc/table_lookup.cu),
from tests/torch_port_fixtures.py: their plain versions against the JAX
functions on the CPU, exactly (the outputs are integers). chip_smoke.py
holds the kernels against these plain versions on the same shapes on the
card.

- The block DCT's plain version (one sequential fma chain per output)
  against the jitted dmmt_jpeg_encoder_tpu.ops.fused.fused_reference, for
  N of one block, a tile less one, a tile, a tile and one, three tiles and
  five.
- The grouped lookup's plain version against pallas_table_lookup_grouped
  for every (G, m, T) of LOOKUP_EDGE_SHAPES, with symbols in range: the
  JAX CPU fallback clamps the others (ROADMAP C2). With -1, T and T + 1
  among the symbols, against the kernels' contract in numpy: 0 outside
  [0, T), the group's entry inside.

The same for the scan-pack kernel (csrc/scan_pack.cu) and the phase-1
kernel (csrc/phase1.cu), on the edge cases of their tilings and coding
(SCAN_PACK_EDGE_CASES, PHASE1_EDGE_CASES), with tables built from each
case's own histograms:

- pack_scan_plain against the JAX package's staged device packer
  (block_emissions + pack_to_words + byteswap_words, jitted; the lookups
  fall back to gathers on the CPU) and, where the scan is whole MCUs,
  against its host packer (packer.encode_scan, stuffed bytes); with each
  `valid` mask, against the JAX packer on the valid blocks alone; the slab
  form against the JAX packer image by image;
- phase1_zigzag_blocks (DC DPCM'd) against the JAX run_device_pipeline,
  except the 7x17 and 333x1001 8-bit geometries, which
  test_torch_phase1.py holds already.

And for the stuffing kernel (csrc/scan_stuff.cu) on STUFF_EDGE_CASES: its
plain version's stuffed tail against the JAX package's host stuffing
(finalize_scan_bytes), byte for byte, and -1 where the tail is too short."""

import re
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dmmt_jpeg_encoder_tpu as dj
from dmmt_jpeg_encoder_tpu.bitstream import device_pack as jpack
from dmmt_jpeg_encoder_tpu.bitstream.packer import encode_scan
from dmmt_jpeg_encoder_tpu.ops import fused as jfused
from dmmt_jpeg_encoder_tpu.ops.pallas_lookup import pallas_table_lookup_grouped
from dmmt_jpeg_encoder_tpu.pipeline import run_device_pipeline
from dmmt_jpeg_encoder_tpu.tables import quantization_table_pair
from dmmt_jpeg_encoder_tpu_torch.bitstream import device_pack as tpack
from dmmt_jpeg_encoder_tpu_torch.bitstream import fused_pack, scan_stuff
from dmmt_jpeg_encoder_tpu_torch.config import ChromaSubsamplingPreset
from dmmt_jpeg_encoder_tpu_torch.ops.fused import fused_dct_quantize_zigzag, fused_matrix, fused_reference
from dmmt_jpeg_encoder_tpu_torch.ops.lookup import table_lookup_grouped
from dmmt_jpeg_encoder_tpu_torch.pipeline import dc_dpcm, phase1_zigzag_blocks
from torch_port_fixtures import (
    BLOCK_DCT_EDGE_N,
    LOOKUP_EDGE_SHAPES,
    PHASE1_EDGE_CASES,
    SCAN_PACK_EDGE_CASES,
    SCAN_PACK_EDGE_MASKS,
    SCAN_PACK_SLAB_EDGES,
    SCAN_PACK_TILE,
    SCAN_PACK_TILE_WORDS,
    STUFF_CHUNK,
    STUFF_EDGE_CASES,
    block_dct_edge_inputs,
    lookup_edge_inputs,
    phase1_edge_pixels,
    scan_pack_edge_blocks,
    scan_pack_edge_mask,
    scan_pack_tables,
    stuff_edge_rows,
)

CSRC = Path(__file__).resolve().parent.parent / "dmmt_jpeg_encoder_tpu_torch" / "csrc"

_jax_fused_reference = jax.jit(jfused.fused_reference)


@pytest.mark.parametrize("n", BLOCK_DCT_EDGE_N)
def test_block_dct_plain_matches_jax_on_edge_shapes(n):
    blocks, q = block_dct_edge_inputs(n)
    want = np.asarray(_jax_fused_reference(jnp.asarray(blocks), jnp.asarray(q)))
    got = fused_dct_quantize_zigzag(torch.from_numpy(blocks), q)
    assert got.dtype == torch.int16 and tuple(got.shape) == (n, 64)
    np.testing.assert_array_equal(got.numpy(), want)
    direct = fused_reference(torch.from_numpy(blocks), torch.from_numpy(fused_matrix(q)))
    np.testing.assert_array_equal(direct.numpy(), want)


@pytest.mark.parametrize("g,m,t", LOOKUP_EDGE_SHAPES)
def test_lookup_plain_matches_jax_on_edge_shapes(g, m, t):
    sym, tables = lookup_edge_inputs(g, m, t, in_range=True)
    want = np.asarray(pallas_table_lookup_grouped(jnp.asarray(sym), jnp.asarray(tables)))
    got = table_lookup_grouped(torch.from_numpy(sym), torch.from_numpy(tables.astype(np.int32)))
    assert got.dtype == torch.int32 and tuple(got.shape) == (g, m)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))

    sym, tables = lookup_edge_inputs(g, m, t, in_range=False)
    inside = (sym >= 0) & (sym < t)
    assert not inside.all()
    entries = np.take_along_axis(tables.astype(np.int32), np.where(inside, sym, 0), axis=1)
    got = table_lookup_grouped(torch.from_numpy(sym), torch.from_numpy(tables.astype(np.int32)))
    np.testing.assert_array_equal(got.numpy(), np.where(inside, entries, 0))


@partial(jax.jit, static_argnames="n_words")
def _jax_pack(scan, table_idx, dc_comb, ac_comb, n_words):
    vals, lens, offs, bits = jpack.block_emissions(scan, table_idx, dc_comb, ac_comb)
    words, total = jpack.pack_to_words(vals, lens, offs, bits, n_words)
    return jpack.byteswap_words(words), total


def _jax_words(blocks, stride, lpm, codes, lens, n_words, keep=None):
    """The JAX packer's memory-order words and bit count for the scan, or
    for its blocks where `keep` is set (each keeping its table set)."""
    chroma = (np.arange(len(blocks)) % stride >= lpm).astype(np.int32)
    if keep is not None:
        blocks, chroma = blocks[keep != 0], chroma[keep != 0]
    if len(blocks) == 0:
        return np.zeros(n_words, np.int32), 0
    dc_comb = np.concatenate([jpack.combine_tables(codes[i][:16], lens[i][:16]) for i in (0, 2)])
    ac_comb = np.concatenate([jpack.combine_tables(codes[i], lens[i]) for i in (1, 3)])
    words, bits = _jax_pack(jnp.asarray(blocks), jnp.asarray(chroma), jnp.asarray(dc_comb),
                            jnp.asarray(ac_comb), n_words=n_words)
    return np.asarray(words).view(np.int32), int(bits)


def _plain_pack(blocks, stride, lpm, codes, lens, valid=None):
    """The scan-pack wrapper on CPU tensors (its plain version)."""
    n_words = len(blocks) * 64 + 2
    words, bits = fused_pack.fused_pack_words(
        torch.from_numpy(blocks), stride, lpm, torch.from_numpy(codes), torch.from_numpy(lens),
        n_words, None if valid is None else torch.from_numpy(valid))
    return words.numpy(), int(bits)


@pytest.mark.parametrize("case", SCAN_PACK_EDGE_CASES)
def test_scan_pack_plain_matches_jax_on_edge_cases(case):
    blocks, stride, lpm = scan_pack_edge_blocks(case)
    codes, lens = scan_pack_tables(blocks, stride, lpm)
    n = len(blocks)
    words, bits = _plain_pack(blocks, stride, lpm, codes, lens)
    want, want_bits = _jax_words(blocks, stride, lpm, codes, lens, n * 64 + 2)
    assert bits == want_bits
    np.testing.assert_array_equal(words, want)
    if n % stride == 0:
        mcus = blocks.reshape(n // stride, stride, 64)
        stream = encode_scan(mcus[:, :lpm].reshape(-1, 64), mcus[:, lpm], mcus[:, lpm + 1], lpm,
                             *zip(codes, lens))
        assert tpack.finalize_scan_bytes(words, bits) == stream


@pytest.mark.parametrize("mask", SCAN_PACK_EDGE_MASKS)
def test_scan_pack_plain_valid_masks_match_jax(mask):
    blocks, stride, lpm = scan_pack_edge_blocks("tiles3+5")
    codes, lens = scan_pack_tables(blocks, stride, lpm)
    valid = scan_pack_edge_mask(mask, len(blocks))
    words, bits = _plain_pack(blocks, stride, lpm, codes, lens, valid)
    want, want_bits = _jax_words(blocks, stride, lpm, codes, lens, len(blocks) * 64 + 2, valid)
    assert bits == want_bits
    np.testing.assert_array_equal(words, want)


@pytest.mark.parametrize("images", SCAN_PACK_SLAB_EDGES, ids=lambda c: "+".join(c))
def test_scan_pack_slab_plain_matches_jax_per_image(images):
    cases = [scan_pack_edge_blocks(c) for c in images]
    (_, stride, lpm), n = cases[0], len(cases[0][0])
    tables = [scan_pack_tables(*c) for c in cases]
    scans = torch.from_numpy(np.stack([b for b, _, _ in cases]))
    codes, lens = (torch.from_numpy(np.stack([t[i] for t in tables])) for i in (0, 1))
    words, bits = fused_pack.fused_pack_words_slab(scans, stride, lpm, codes, lens, n * 64 + 2)
    for i, ((blocks, _, _), (c, ln)) in enumerate(zip(cases, tables)):
        want, want_bits = _jax_words(blocks, stride, lpm, c, ln, n * 64 + 2)
        assert int(bits[i]) == want_bits
        np.testing.assert_array_equal(words[i].numpy(), want)


def test_scan_pack_edge_constants_are_the_kernels():
    src = (CSRC / "scan_pack.cu").read_text()
    assert int(re.search(r"constexpr int TILE = (\d+);", src)[1]) == SCAN_PACK_TILE == fused_pack.TILE
    assert int(re.search(r"constexpr int TILE_WORDS = (\d+);", src)[1]) == SCAN_PACK_TILE_WORDS
    # the over-full case passes the shared buffer in its first tile, no other case does
    for case in SCAN_PACK_EDGE_CASES:
        blocks, stride, lpm = scan_pack_edge_blocks(case)
        codes, lens = scan_pack_tables(blocks, stride, lpm)
        bits = _plain_pack(blocks[:SCAN_PACK_TILE], stride, lpm, codes, lens)[1]
        assert (bits > 32 * (SCAN_PACK_TILE_WORDS - 1)) == (case == "overfull"), case


@pytest.mark.parametrize("case", STUFF_EDGE_CASES)
def test_stuff_plain_matches_jax_finalize_on_edge_cases(case):
    words, bits = stuff_edge_rows(case)
    rows = torch.from_numpy(words.copy())
    lengths = scan_stuff.stuff_scan(rows if len(bits) > 1 else rows[0], torch.from_numpy(bits))
    assert lengths.tolist() == [int(rows[r].view(torch.int64)[-1]) for r in range(len(bits))]
    _, state_off = scan_stuff.tail_layout(4 * words.shape[1])
    for r, nbits in enumerate(bits.tolist()):
        want = jpack.finalize_scan_bytes(words[r], nbits)
        start, raw = scan_stuff.stuffed_start(nbits), rows[r].view(torch.uint8).numpy()
        n_bytes = (nbits + 7) // 8
        np.testing.assert_array_equal(raw[:n_bytes], words[r].view(np.uint8)[:n_bytes])  # kept
        if start + len(want) > state_off:
            assert int(lengths[r]) == -1 and case.startswith("short")
        else:
            assert int(lengths[r]) == len(want) >= n_bytes
            assert raw[start : start + len(want)].tobytes() == want


def test_stuff_edge_constants_are_the_kernels():
    src = (CSRC / "scan_stuff.cu").read_text()
    threads = int(re.search(r"constexpr int THREADS = (\d+);", src)[1])
    per_thread = int(re.search(r"constexpr int BYTES = (\d+);", src)[1])
    assert threads * per_thread == STUFF_CHUNK == scan_stuff.CHUNK
    # the cases reach the edges they name: three chunks, twice a chunk's bytes stuffed
    words, bits = stuff_edge_rows("all_ff")
    assert (int(bits[0]) + 7) // 8 > 2 * STUFF_CHUNK


@pytest.mark.parametrize("h,w,preset,maxval", [
    c for c in PHASE1_EDGE_CASES if not (c[:2] in ((7, 17), (333, 1001)) and c[3] == 255)])
def test_phase1_plain_matches_jax_on_edge_geometries(h, w, preset, maxval):
    px = phase1_edge_pixels(h, w, maxval)
    cfg = dj.EncoderConfig(chroma_subsampling=dj.ChromaSubsamplingPreset(preset))
    lq, cq = quantization_table_pair(cfg.quantization_preset)
    ref = run_device_pipeline(px, maxval, cfg, lq, cq)
    got = phase1_zigzag_blocks(torch.from_numpy(px), maxval, torch.from_numpy(lq),
                               torch.from_numpy(cq), ChromaSubsamplingPreset(preset))
    for want, blocks in zip((ref.luma, ref.cb, ref.cr), got):
        assert blocks.dtype == torch.int16
        np.testing.assert_array_equal(dc_dpcm(blocks).numpy(), np.asarray(want))
