"""PyTorch port, scan packing: the scan-pack kernel's plain version
(block_emissions + pack_to_words + byteswap) and the host tail, against
the JAX package's device packer and its host C/Python packer, exactly.
The stuffing behind the pack (bitstream/scan_stuff.py, its plain version
here) against the JAX package's host packer and host stuffing, on packed
scans of every 1-pad; and a finish whose word buffer is too short for the
stuffed copy, which stuffs on the host (dmmt.stuff_host) to the same
bytes."""

import dataclasses

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmmt_jpeg_encoder_tpu.bitstream import device_pack as jpack
from dmmt_jpeg_encoder_tpu.bitstream.packer import encode_scan
from dmmt_jpeg_encoder_tpu.huffman.canonical import flat_code_arrays
from dmmt_jpeg_encoder_tpu.huffman.spec import code_lengths_from_histogram
from dmmt_jpeg_encoder_tpu_torch.bitstream import device_pack as tpack
from dmmt_jpeg_encoder_tpu_torch import onedispatch as tod
from dmmt_jpeg_encoder_tpu_torch.bitstream import scan_stuff
from dmmt_jpeg_encoder_tpu_torch.bitstream.fused_pack import fused_pack_words
from dmmt_jpeg_encoder_tpu_torch.config import EncoderConfig
from dmmt_jpeg_encoder_tpu_torch.tables import quantization_table_pair
from dmmt_jpeg_encoder_tpu_torch.entropy.categorize import symbol_histograms
from torch_port_fixtures import random_blocks


def _scan_case(luma_per_mcu: int, n_mcu: int, seed: int):
    """Luma/Cb/Cr blocks, flat tables built on the host from their
    histograms (the port's, pinned to the JAX package's in
    test_torch_entropy), and the scan."""
    b = random_blocks(seed, n=n_mcu * (luma_per_mcu + 2))
    n_luma = n_mcu * luma_per_mcu
    luma, cb, cr = b[:n_luma], b[n_luma : n_luma + n_mcu], b[n_luma + n_mcu :]
    hists = [h.numpy() for part in (luma, np.concatenate([cb, cr]))
             for h in symbol_histograms(torch.from_numpy(part))]
    tables = [flat_code_arrays(code_lengths_from_histogram(h)) for h in hists]
    codes = np.zeros((4, 256), np.int32)
    lens = np.zeros((4, 256), np.int32)
    for i, (c, ln) in enumerate(tables):
        codes[i, : len(c)], lens[i, : len(ln)] = c, ln
    scan = tpack.interleave_scan(
        torch.from_numpy(luma), torch.from_numpy(cb), torch.from_numpy(cr), n_mcu, luma_per_mcu
    )
    return (luma, cb, cr), hists, tables, codes, lens, scan


CASES = [(1, 40, 0), (2, 30, 1), (4, 25, 2), (4, 300, 3)]


@partial(jax.jit, static_argnames="n_words")
def jax_pack(scan, table_idx, dc_comb, ac_comb, n_words):
    """The JAX package's staged device packer (lookups fall back to gathers
    on the CPU): memory-order words and the total bit count."""
    vals, lens, offs, bits = jpack.block_emissions(scan, table_idx, dc_comb, ac_comb)
    words, total = jpack.pack_to_words(vals, lens, offs, bits, n_words)
    return jpack.byteswap_words(words), total


@pytest.mark.parametrize("lpm,n_mcu,seed", CASES)
def test_interleave_matches_jax(lpm, n_mcu, seed):
    (luma, cb, cr), _, _, _, _, scan = _scan_case(lpm, n_mcu, seed)
    want = jpack._interleave_scan(jnp.asarray(luma), jnp.asarray(cb), jnp.asarray(cr), n_mcu, lpm)
    np.testing.assert_array_equal(scan.numpy(), np.asarray(want))


@pytest.mark.parametrize("lpm,n_mcu,seed", CASES)
def test_words_and_bits_match_jax_pack_to_words(lpm, n_mcu, seed):
    _, _, tables, codes, lens, scan = _scan_case(lpm, n_mcu, seed)
    n = int(scan.shape[0])
    n_words = n * 64 + 2
    is_chroma = (np.arange(n) % (lpm + 2)) >= lpm
    dc_comb = np.concatenate([jpack.combine_tables(t[0][:16], t[1][:16]) for t in tables[0::2]])
    ac_comb = np.concatenate([jpack.combine_tables(t[0], t[1]) for t in tables[1::2]])
    jw, jbits = jax_pack(
        jnp.asarray(scan.numpy()), jnp.asarray(is_chroma.astype(np.int32)),
        jnp.asarray(dc_comb), jnp.asarray(ac_comb), n_words=n_words,
    )
    want = np.asarray(jw).view(np.int32)

    words, bits = fused_pack_words(scan, lpm + 2, lpm, torch.from_numpy(codes),
                                   torch.from_numpy(lens), n_words)
    assert words.dtype == torch.int32 and bits.dtype == torch.int64
    assert int(bits) == int(jbits)
    np.testing.assert_array_equal(words.numpy(), want)


@pytest.mark.parametrize("lpm,n_mcu,seed", CASES)
def test_stuffed_bytes_match_host_packer(lpm, n_mcu, seed):
    (luma, cb, cr), hists, tables, codes, lens, scan = _scan_case(lpm, n_mcu, seed)
    n_words = int(scan.shape[0]) * 64 + 2
    words, bits = tpack.pack_scan_plain(scan, lpm + 2, lpm, torch.from_numpy(codes),
                                        torch.from_numpy(lens), n_words)
    got = tpack.finalize_scan_bytes(words.numpy(), int(bits))
    assert got == encode_scan(luma, cb, cr, lpm, *tables)
    assert tpack.exact_scan_bits(tuple(hists), *tables) == int(bits)


def test_pack_wrapper_guards():
    scan = torch.zeros((3, 64), dtype=torch.int16)
    tab = torch.zeros((4, 256), dtype=torch.int32)
    with pytest.raises(ValueError):
        fused_pack_words(scan, 3, 1, tab, tab, 3 * 64 + 1)  # below the worst case
    with pytest.raises(ValueError):
        fused_pack_words(scan.to("meta"), 3, 1, tab, tab, 3 * 64 + 2)


@pytest.mark.parametrize("lpm,n_mcu,seed", CASES)
def test_stuffed_tail_matches_host_packer(lpm, n_mcu, seed):
    (luma, cb, cr), _, tables, codes, lens, scan = _scan_case(lpm, n_mcu, seed)
    words, bits = fused_pack_words(scan, lpm + 2, lpm, torch.from_numpy(codes),
                                   torch.from_numpy(lens), int(scan.shape[0]) * 64 + 2)
    raw = words.numpy().copy()
    (length,) = scan_stuff.stuff_scan(words, bits).tolist()
    start = scan_stuff.stuffed_start(int(bits))
    got = words.view(torch.uint8)[start : start + length].numpy().tobytes()
    assert got == encode_scan(luma, cb, cr, lpm, *tables) == jpack.finalize_scan_bytes(raw, int(bits))


@pytest.mark.parametrize("pad", range(8))
def test_stuffed_tail_of_each_pad_matches_jax_finalize(pad):
    """Packed scans cut to end `pad` bits short of a byte (the words past
    the cut zeroed, as a shorter stream leaves them) and stuffed."""
    _, _, _, codes, lens, scan = _scan_case(2, 30, 1)
    words, bits = fused_pack_words(scan, 4, 2, torch.from_numpy(codes), torch.from_numpy(lens),
                                   int(scan.shape[0]) * 64 + 2)
    cut = (int(bits) // 8 - 1) * 8 - pad
    raw = words.view(torch.uint8)
    raw[(cut + 7) // 8 :] = 0
    if cut % 8:
        raw[cut // 8] &= (0xFF << (8 - cut % 8)) & 0xFF
    want = jpack.finalize_scan_bytes(words.numpy().copy(), cut)
    (length,) = scan_stuff.stuff_scan(words, torch.tensor([cut])).tolist()
    start = scan_stuff.stuffed_start(cut)
    assert raw[start : start + length].numpy().tobytes() == want


def _stuff_spans(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    names = [e.name for e in prof.events() if e.name.startswith("dmmt.stuff")]
    return out, {n: names.count(n) for n in set(names)}


def test_finish_stuffs_on_the_host_where_the_tail_is_short():
    """A state whose word buffer leaves 2 words past the stream (no room
    for the stuffed copy, length -1) finishes to the bytes of the stuffed
    tail, stuffed by the host; a real buffer's finish copies the tail."""
    rng = np.random.default_rng(31)
    px = rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
    cfg = EncoderConfig()
    lq, cq = quantization_table_pair(cfg.quantization_preset, cfg.quality)
    (want, tables), on_card = _stuff_spans(lambda: tod.finish_one_dispatch(
        tod.start_one_dispatch(px, 255, cfg, lq, cq, device="cpu")))
    assert on_card == {"dmmt.stuff": 1, "dmmt.stuff_card": 1}
    state = tod.start_one_dispatch(px, 255, cfg, lq, cq, device="cpu")
    n = (int(state.total_bits) + 31) // 32
    short = torch.zeros(n + 2 + n % 2, dtype=torch.int32)
    short[:n] = state.words[:n]
    stuffed = scan_stuff.stuff_scan(short, state.total_bits)
    assert stuffed.tolist() == [-1]
    (got, got_tables), on_host = _stuff_spans(lambda: tod.finish_one_dispatch(
        dataclasses.replace(state, words=short, stuffed=stuffed)))
    assert on_host == {"dmmt.stuff": 1, "dmmt.stuff_host": 1}
    assert got == want and got_tables == tables
