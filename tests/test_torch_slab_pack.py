"""PyTorch port, the slab pieces: per-image DC DPCM, the slab scan-pack
kernel's plain version and the per-image block ranges of a row-stacked
phase 1, each against the JAX package (or the port's own single-image
function), exactly.

The slab pack is held against the JAX package's Pallas kernel
`fused_pack_words_slab` in interpret mode, at the JAX suite's own sizes
(tests/test_slab_onepack.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmmt_jpeg_encoder_tpu import pipeline as jpipe
from dmmt_jpeg_encoder_tpu.bitstream.device_pack import _interleave_scan
from dmmt_jpeg_encoder_tpu.bitstream.fused_pack import fused_pack_capacity
from dmmt_jpeg_encoder_tpu.bitstream.fused_pack import fused_pack_words_slab as jax_slab_pack
from dmmt_jpeg_encoder_tpu.entropy.categorize import symbol_histograms as jax_hists
from dmmt_jpeg_encoder_tpu.huffman import device_tables as jtables
from dmmt_jpeg_encoder_tpu.onedispatch import K_AC_CAP, K_DC_CAP
from dmmt_jpeg_encoder_tpu_torch.bitstream.device_pack import pack_scan_plain, pack_scan_slab_plain
from dmmt_jpeg_encoder_tpu_torch.bitstream.fused_pack import fused_pack_words_slab
from dmmt_jpeg_encoder_tpu_torch.config import ChromaSubsamplingPreset, QuantizationTablePreset
from dmmt_jpeg_encoder_tpu_torch.ops.geometry import padded_size
from dmmt_jpeg_encoder_tpu_torch.pipeline import dc_dpcm, dc_dpcm_per_image, phase1_zigzag_blocks
from dmmt_jpeg_encoder_tpu_torch.tables import quantization_table_pair
from torch_port_fixtures import random_blocks


@pytest.mark.parametrize("n_images", [1, 3, 4])
def test_dc_dpcm_per_image_matches_jax(n_images):
    blocks = random_blocks(40 + n_images, n=12 * n_images)
    want = jax.jit(jpipe.dc_dpcm_per_image, static_argnums=1)(
        jnp.asarray(blocks[:, 0].astype(np.int32)), n_images)
    got = dc_dpcm_per_image(torch.from_numpy(blocks), n_images)
    np.testing.assert_array_equal(got[:, 0].numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[:, 1:].numpy(), blocks[:, 1:])
    # each image's chain equals a standalone one
    for i, part in enumerate(np.split(blocks, n_images)):
        assert torch.equal(got[i * 12 : (i + 1) * 12], dc_dpcm(torch.from_numpy(part)))


def _jax_image_tables(luma, cb, cr):
    """One image's four JAX device tables and its sweep-table arguments, as
    the JAX one-pack path builds them."""
    l_dc, l_ac = jax_hists(jnp.asarray(luma))
    c_dc, c_ac = jax_hists(jnp.asarray(np.concatenate([cb, cr])))
    t_all = jtables.device_code_tables_batched(jnp.stack([
        jtables.pad_dc_histogram(l_dc), l_ac.astype(jnp.int32),
        jtables.pad_dc_histogram(c_dc), c_ac.astype(jnp.int32)]))
    t4 = tuple({k: v[i] for k, v in t_all.items()} for i in range(4))
    dc_s, dc_la, dc_ca, k_dc = jtables.device_sweep_tables(t4[0], t4[2], K_DC_CAP)
    ac_s, ac_la, ac_ca, k_ac = jtables.device_sweep_tables(t4[1], t4[3], K_AC_CAP)
    l_ent = (t4[1]["codes_flat"] << 8) | t4[1]["lens_flat"]
    c_ent = (t4[3]["codes_flat"] << 8) | t4[3]["lens_flat"]
    misc = jnp.stack([l_ent[0xF0], c_ent[0xF0], l_ent[0x00], c_ent[0x00]])
    flat = [np.stack([np.asarray(t[k]) for t in t4]) for k in ("codes_flat", "lens_flat")]
    return (dc_s, dc_la, dc_ca, ac_s, ac_la, ac_ca, misc), jnp.stack([k_dc, k_ac]), flat


@pytest.mark.parametrize("b,n_mcu", [(2, 40), (3, 17), (8, 9)])
def test_slab_pack_plain_matches_jax_slab_kernel(monkeypatch, b, n_mcu):
    monkeypatch.setenv("DMMT_PALLAS_INTERPRET", "1")
    lpm, stride = 4, 6
    scans, sweeps, k_dyn, codes, lens = [], [], [], [], []
    for i in range(b):
        blk = random_blocks(100 * b + i, n=n_mcu * stride)
        luma, cb, cr = np.split(blk, [n_mcu * lpm, n_mcu * (lpm + 1)])
        sweep, kd, (c, ln) = _jax_image_tables(luma, cb, cr)
        scans.append(np.asarray(_interleave_scan(
            jnp.asarray(luma), jnp.asarray(cb), jnp.asarray(cr), n_mcu, lpm)))
        sweeps.append(sweep)
        k_dyn.append(kd)
        codes.append(c)
        lens.append(ln)
    n_blocks = n_mcu * stride
    n_words = fused_pack_capacity(n_blocks * 64 + 2)
    jw, jbits = jax_slab_pack(
        jnp.asarray(np.stack(scans)), stride, lpm,
        tuple(jnp.stack([s[j] for s in sweeps]) for j in range(7)), n_words,
        k_dyn=jnp.stack(k_dyn))
    jw, jbits = np.asarray(jw).view(np.int32), np.asarray(jbits)

    t_scans = torch.from_numpy(np.stack(scans))
    t_codes, t_lens = torch.from_numpy(np.stack(codes)), torch.from_numpy(np.stack(lens))
    words, bits = pack_scan_slab_plain(t_scans, stride, lpm, t_codes, t_lens, n_blocks * 64 + 2)
    assert words.shape == (b, n_blocks * 64 + 2) and bits.shape == (b,)
    for i in range(b):
        assert int(bits[i]) == int(jbits[i]), f"image {i} bit count"
        nw = (int(bits[i]) + 31) // 32
        np.testing.assert_array_equal(words[i, :nw].numpy(), jw[i, :nw], err_msg=f"image {i}")
        one_w, one_b = pack_scan_plain(t_scans[i], stride, lpm, t_codes[i], t_lens[i],
                                       n_blocks * 64 + 2)
        assert torch.equal(words[i], one_w) and int(one_b) == int(bits[i])
    # the wrapper takes the plain version for CPU tensors
    ww, wb = fused_pack_words_slab(t_scans, stride, lpm, t_codes, t_lens, n_blocks * 64 + 2)
    assert torch.equal(ww, words) and torch.equal(wb, bits)


def test_slab_pack_wrapper_guards():
    scans = torch.zeros((2, 3, 64), dtype=torch.int16)
    tab = torch.zeros((2, 4, 256), dtype=torch.int32)
    with pytest.raises(ValueError):
        fused_pack_words_slab(scans, 3, 1, tab, tab, 3 * 64 + 1)  # below the worst case
    with pytest.raises(ValueError):
        fused_pack_words_slab(scans[0], 3, 1, tab, tab, 3 * 64 + 2)  # not [B, N, 64]
    with pytest.raises(ValueError):
        fused_pack_words_slab(scans, 3, 1, tab[:1], tab[:1], 3 * 64 + 2)  # one table set
    with pytest.raises(ValueError):
        fused_pack_words_slab(scans.to("meta"), 3, 1, tab, tab, 3 * 64 + 2)


@pytest.mark.parametrize("preset", ["P420", "P422", "P444"])
def test_row_stacked_phase1_blocks_are_per_image_ranges(preset):
    """Phase 1 on B MCU-padded images stacked by rows gives each image's
    luma (MCU order) and chroma blocks as one contiguous range, equal to a
    standalone phase 1 of that image."""
    p = ChromaSubsamplingPreset(preset)
    h, w, b = 13, 21, 3
    ph, pw = padded_size(h, w, p)
    rng = np.random.default_rng(7)
    imgs = [rng.integers(0, 256, (h, w, 3)).astype(np.uint8) for _ in range(b)]
    stack = np.zeros((b, ph, pw, 3), np.uint8)
    stack[:, :h, :w] = np.stack(imgs)
    lq, cq = (torch.from_numpy(t)
              for t in quantization_table_pair(QuantizationTablePreset.SPECIFICATION, None))
    tall = phase1_zigzag_blocks(torch.from_numpy(stack).reshape(b * ph, pw, 3), 255, lq, cq, p)
    for i, px in enumerate(imgs):
        for whole, one in zip(tall, phase1_zigzag_blocks(torch.from_numpy(px), 255, lq, cq, p)):
            n = one.shape[0]
            assert whole.shape[0] == b * n
            assert torch.equal(whole[i * n : (i + 1) * n], one)

