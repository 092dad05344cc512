"""Entropy-scan packing on the device, plus the host tail.

Counterpart of dmmt_jpeg_encoder_tpu.bitstream.device_pack:

- `interleave_scan` / `scan_order_permutation`: Y..Y Cb Cr per MCU
  (reference interleave, src/image/writer/jpeg/encoder/block_fold_iterator.rs:75-148);
  the pack gathers with `interleave_scan` and marks chroma blocks with
  `chroma_index` on the device. `scan_order_permutation` is the JAX
  package's host index form of the same order.
- `block_emissions` + `pack_to_words` + `byteswap_words`: the staged scan
  pack. Every (block, slot) becomes a (value, bit-length, block-relative
  offset) triple: 1 DC (codeword and magnitude bits fused), 63 AC (length
  0 where the coefficient is zero), 3 ZRL, 1 EOB. Block offsets are an
  exclusive prefix sum; each emission lands in at most two big-endian
  32-bit words, and bit ranges are disjoint, so adding is OR-ing. The
  emission arrays are int32 (a 16 x 1080p batch holds 783,360 blocks, so
  each [N, 68] array is 213 MB); words are the uint32 bit patterns in
  int32. The codeword lookups run the lookup kernel (ops/lookup.py);
  `pack_to_words` is the emission-pack kernel's plain version
  (bitstream/emission_pack.py).
- `pack_scan_plain` / `pack_scan_slab_plain`: the scan-pack kernels'
  plain versions (bitstream/fused_pack.py), built from the same pieces
  with plain lookups; `mask_emissions` applies their `valid` mask;
  `staged_pack_words` is the same chain through the lookup and
  emission-pack kernels (the sharded encode's staged arm).
- `device_pack_scan` / `device_pack_scan_batch`: the two-dispatch pack of
  one image (the scan-pack kernel, or with DMMT_NO_FUSED_PACK=1 the staged
  pack) and of a fused batch (the staged pack, each image's stream at a
  word-aligned base, one fetch), given the exact stream length. On a card
  each is one replay of a program (`_compiled_fused_pack`, `_compiled_pack`,
  `_compiled_pack_batch`, maxsize 64 / 32 / 16 as in the JAX package) of
  `pack_enqueue`, which the CPU runs eagerly: the blocks are copied into
  the program's inputs, the host tables and word bases (`pack_values`)
  through its pinned staging, and the instance is given back after the
  word fetch (programs.run_once). The staged packs' word buffers are the
  JAX package's power-of-two bucket (`words_capacity`), so one program
  serves many streams; the fused pack keeps the worst case of the shape.
- `finalize_scan_bytes` / `pad_and_stuff` / `exact_scan_bits`: host
  numpy; `check_scan_bits` holds a pack's bit count to exact_scan_bits
  under DMMT_CHECK_BITS. The fused pack stuffs on the device behind the
  scan-pack kernel (bitstream/scan_stuff.py), and its read fetches final
  bytes; the host stuffs the staged packs' streams, the fused batch's and
  the sharded tail's, and a fused pack's where its word buffer's tail had
  no room.

Table lookups assume every symbol present in the data has a codeword,
which holds when the tables were built from this image's own histograms.
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np
import torch

from .. import programs
from ..entropy.categorize import magnitude_category, running_max, running_sum
from ..ops.lookup import table_lookup_grouped, table_lookup_grouped_plain
from ..utils.capability import mode_keyed_cache
from ..utils.device import upload
from ..utils.profiling import span
from .scan_stuff import stuff_scan, stuffed_start

# Static per-block worst case: DC 31 bits, 63 AC emissions of <=31 bits,
# 3 ZRL of <=16 bits, EOB <=16 bits -> round up to 64 words.
MAX_BLOCK_BITS = 2048
N_SLOTS = 68  # emissions per block: 1 DC + 63 AC + 3 ZRL + 1 EOB
_MASK32 = 0xFFFFFFFF


def interleave_scan(
    luma: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor, n_mcu: int, luma_per_mcu: int
) -> torch.Tensor:
    """[NL, 64] luma (MCU order) + [NC, 64] cb/cr -> [NL + 2NC, 64] blocks
    in scan order."""
    return torch.cat(
        [luma.reshape(n_mcu, luma_per_mcu, 64), cb[:, None, :], cr[:, None, :]], dim=1
    ).reshape(-1, 64)


@lru_cache(maxsize=32)
def scan_order_permutation(
    n_luma: int, n_chroma: int, luma_per_mcu: int
) -> tuple[np.ndarray, np.ndarray]:
    """(perm, is_luma) mapping scan position -> index into the concatenated
    [luma; cb; cr] block array."""
    if n_chroma == 0:
        return np.arange(n_luma, dtype=np.int32), np.ones(n_luma, dtype=bool)
    n_mcu = n_chroma
    perm = np.empty(n_luma + 2 * n_chroma, dtype=np.int32)
    is_luma = np.zeros(n_luma + 2 * n_chroma, dtype=bool)
    stride = luma_per_mcu + 2
    for j in range(luma_per_mcu):
        perm[j::stride] = np.arange(n_mcu) * luma_per_mcu + j
        is_luma[j::stride] = True
    perm[luma_per_mcu::stride] = n_luma + np.arange(n_mcu)
    perm[luma_per_mcu + 1 :: stride] = n_luma + n_chroma + np.arange(n_mcu)
    return perm, is_luma


def _pattern(v: torch.Tensor, cat: torch.Tensor) -> torch.Tensor:
    """JPEG magnitude bits: v for positives, one's complement for negatives
    (reference: src/...transformer/categorize.rs:45-74)."""
    return torch.where(v >= 0, v, v + (1 << cat) - 1)


def _exclusive_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.cumsum(x, dim=dim, dtype=x.dtype) - x


def _int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the same uint32 bit patterns as int32."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def combine_tables(codes: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """(codeword << 8 | length) combined lookup entries, int32 (< 2^24)."""
    return (codes.to(torch.int32) << 8) | lens.to(torch.int32)


def block_emissions(
    zz: torch.Tensor,
    table_idx: torch.Tensor,
    dc_comb: torch.Tensor,
    ac_comb: torch.Tensor,
    groups: int = 1,
    plain: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-block emission triples for scan-order blocks.

    zz: int [N, 64] zigzag coefficients (DC already DPCM).
    table_idx: int [N] code-table set per block: 0 = luma, 1 = chroma for
        one image; image * 2 + chroma for a batch of `groups` images of
        N / groups blocks each.
    dc_comb / ac_comb: int32 [groups * 2 * 16] / [groups * 2 * 256]
        combined (code << 8 | len) entries (combine_tables), per image
        luma first.
    plain: look the codewords up with the lookup kernel's plain version
        (the scan-pack kernels' plain versions do) instead of the kernel.

    Returns int32 (values [N, 68], lens [N, 68], rel_offs [N, 68],
    block_bits [N]).
    """
    i32 = torch.int32
    v = zz.to(i32)
    n = v.shape[0]
    cat = magnitude_category(v)
    t = table_idx.to(i32)
    tmod = t % 2
    lookup = table_lookup_grouped_plain if plain else table_lookup_grouped

    def _lookup(within: torch.Tensor, comb: torch.Tensor, width: int) -> torch.Tensor:
        # per-image tables: each image's blocks look up only its own entries
        out = lookup(within.reshape(groups, -1), comb.reshape(groups, width))
        return out.reshape(within.shape)

    # --- DC ------------------------------------------------------------
    dccat = cat[:, 0]
    dc_cl = _lookup(tmod * 16 + dccat, dc_comb, 32)
    e_dc_val = ((dc_cl >> 8) << dccat) | _pattern(v[:, 0], dccat)
    e_dc_len = (dc_cl & 0xFF) + dccat

    # --- AC structure (categorize.rs:132-151) ---------------------------
    ac = v[:, 1:]
    accat = cat[:, 1:]
    pos = torch.arange(1, 64, dtype=i32, device=v.device)[None, :]
    nz = ac != 0
    zero = torch.zeros_like(ac)
    nzpos = torch.where(nz, pos, zero)
    shifted = torch.cat([zero[:, :1], nzpos[:, :-1]], dim=1)
    run = pos - running_max(shifted) - 1
    zrl = torch.where(nz, run >> 4, zero)
    sym = ((run & 15) << 4) | accat

    ac_cl = _lookup(tmod[:, None] * 256 + sym, ac_comb, 512)
    e_ac_val = torch.where(nz, ((ac_cl >> 8) << accat) | _pattern(ac, accat), zero)
    e_ac_len = torch.where(nz, (ac_cl & 0xFF) + accat, zero)

    # --- ZRL / EOB per-block constants ----------------------------------
    t64 = t.to(torch.int64)
    zrl_cl = ac_comb[t64 * 256 + 0xF0]
    zrl_code, zrl_len = zrl_cl >> 8, zrl_cl & 0xFF
    eob_cl = ac_comb[t64 * 256]
    has_eob = nzpos.amax(dim=1) < 63
    e_eob_len = torch.where(has_eob, eob_cl & 0xFF, torch.zeros_like(eob_cl))

    # --- offsets within the block ---------------------------------------
    pre = zrl * zrl_len[:, None]  # ZRL bits before each position
    seg = pre + e_ac_len
    start = e_dc_len[:, None] + running_sum(seg) - seg
    e_ac_off = start + pre
    ac_total = seg.sum(dim=1, dtype=i32)
    e_eob_off = e_dc_len + ac_total
    block_bits = e_dc_len + ac_total + e_eob_len

    # --- the <=3 ZRL slots ----------------------------------------------
    cz = running_sum(zrl)  # inclusive count of ZRLs up to position
    cz_excl = cz - zrl
    total_z = cz[:, -1]
    zrl_vals, zrl_lens, zrl_offs = [], [], []
    for i in range(3):
        ki = torch.argmax((cz > i).to(i32), dim=1, keepdim=True)
        start_ki = start.gather(1, ki)[:, 0]
        excl_ki = cz_excl.gather(1, ki)[:, 0]
        zrl_offs.append(start_ki + (i - excl_ki) * zrl_len)
        zrl_lens.append(torch.where(total_z > i, zrl_len, torch.zeros_like(zrl_len)))
        zrl_vals.append(zrl_code)

    def cols(first, ac_part, slots, last):
        return torch.cat(
            [first[:, None], ac_part] + [s[:, None] for s in slots] + [last[:, None]], dim=1
        )

    values = cols(e_dc_val, e_ac_val, zrl_vals, eob_cl >> 8)
    lens = cols(e_dc_len, e_ac_len, zrl_lens, e_eob_len)
    offs = cols(torch.zeros(n, dtype=i32, device=v.device), e_ac_off, zrl_offs, e_eob_off)
    return values, lens, offs, block_bits


def mask_emissions(
    emissions: tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor],
    valid: torch.Tensor | None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """block_emissions' (values, lens, offs, block_bits) with every
    emission of a block where `valid` ([N], optional) is zero cut to length
    0: the block adds no bits and emits nothing, as the TPU kernels' mask
    does (bitstream/fused_pack.py:733-740 and :768-799 of the JAX package;
    its staged sharded pack multiplies the same way, sharding.py:856-867)."""
    if valid is None:
        return emissions
    values, lens, offs, block_bits = emissions
    keep = (valid != 0).to(torch.int32)
    return values, lens * keep[:, None], offs, block_bits * keep


def block_offsets(
    block_bits: torch.Tensor, boff: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """(each block's stream bit offset, int64 [N]: `boff`, or the exclusive
    scan of block_bits; total_bits int64 scalar = boff[-1] + block_bits[-1])."""
    bb = block_bits.to(torch.int64)
    boff = _exclusive_cumsum(bb, dim=0) if boff is None else boff.to(torch.int64)
    return boff, boff[-1] + bb[-1]


def pack_to_words(
    values: torch.Tensor,
    lens: torch.Tensor,
    offs: torch.Tensor,
    block_bits: torch.Tensor,
    n_words: int,
    boff: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter emissions into big-endian 32-bit words (logical order); the
    emission-pack kernel's plain version. `boff` overrides the exclusive
    scan of block_bits as each block's stream bit offset; pieces at or past
    word n_words are dropped.

    Returns (words int32 [n_words] holding the uint32 words as bit
    patterns, total_bits int64 scalar tensor)."""
    boff, total_bits = block_offsets(block_bits, boff)
    goff = (boff[:, None] + offs.to(torch.int64)).reshape(-1)
    val = values.to(torch.int64).reshape(-1) & _MASK32
    ln = lens.to(torch.int64).reshape(-1)

    w0 = goff >> 5
    end = (goff & 31) + ln
    # An emission occupies bits [b0, end) of (w0, w0 + 1), MSB first.
    spill = torch.clamp(end - 32, min=0)
    c0 = ((val >> spill) << torch.clamp(32 - end, min=0)) & _MASK32
    c1 = (val << (32 - spill)) & _MASK32

    words = torch.zeros(n_words, dtype=torch.int64, device=val.device)
    keep0 = (ln > 0) & (w0 < n_words)
    keep1 = (ln > 0) & (spill > 0) & (w0 + 1 < n_words)
    words.index_add_(0, w0[keep0], c0[keep0])
    words.index_add_(0, w0[keep1] + 1, c1[keep1])
    return _int32_bits(words), total_bits


def byteswap_words(words: torch.Tensor) -> torch.Tensor:
    """Logical big-endian uint32 words (int32 bit patterns, or int64
    values) -> memory-order words as int32 bit patterns, so a uint8 view of
    the buffer is the stream."""
    w = words.to(torch.int64) & _MASK32
    return _int32_bits(((w & 0xFF) << 24) | ((w & 0xFF00) << 8) | ((w >> 8) & 0xFF00) | (w >> 24))


def _stacked_tables(codes: torch.Tensor, lens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, 4, 256] codes and lengths (luma DC, luma AC, chroma DC, chroma
    AC per image) -> block_emissions' combined dc_comb [B * 32] and
    ac_comb [B * 512]."""
    comb = combine_tables(codes, lens)
    return comb[:, 0::2, :16].reshape(-1), comb[:, 1::2].reshape(-1)


def pack_scan_plain(
    scan: torch.Tensor,
    stride: int,
    luma_per_mcu: int,
    codes_flat: torch.Tensor,
    lens_flat: torch.Tensor,
    n_words: int,
    valid: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The scan-pack kernel's plain version, same contract: scan-order
    blocks [N, 64] (block i is chroma iff i % stride >= luma_per_mcu) and
    the four flat tables [4, 256] (luma DC, luma AC, chroma DC, chroma AC)
    -> (memory-order words int32 [n_words], total_bits int64 [1]). A block
    where `valid` ([N], optional) is zero emits nothing (mask_emissions)."""
    return staged_pack_words(scan, stride, luma_per_mcu, codes_flat, lens_flat, n_words, valid,
                             plain=True)


def staged_pack_words(
    scan: torch.Tensor,
    stride: int,
    luma_per_mcu: int,
    codes_flat: torch.Tensor,
    lens_flat: torch.Tensor,
    n_words: int,
    valid: torch.Tensor | None = None,
    plain: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """pack_scan_plain's contract through the staged pack: block_emissions
    (the lookup kernel), mask_emissions, the emission-pack kernel and
    byteswap_words; with `plain`, the plain versions of both kernels (that
    is pack_scan_plain). Pieces at or past word n_words are dropped."""
    from .emission_pack import pack_emission_words

    table_idx = chroma_index(scan.shape[0], stride, luma_per_mcu, scan.device)
    dc_comb, ac_comb = _stacked_tables(codes_flat[None], lens_flat[None])
    emissions = mask_emissions(block_emissions(
        scan, table_idx, dc_comb, ac_comb, plain=plain
    ), valid)
    pack = pack_to_words if plain else pack_emission_words
    words, total_bits = pack(*emissions, n_words)
    return byteswap_words(words), total_bits.reshape(1)


def pack_scan_slab_plain(
    scans: torch.Tensor,
    stride: int,
    luma_per_mcu: int,
    codes: torch.Tensor,
    lens: torch.Tensor,
    n_words: int,
    valid: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The slab scan-pack kernel's plain version: B independent streams,
    each packed exactly as pack_scan_plain packs it alone. scans [B, N, 64]
    (one image's scan-order blocks each), codes/lens [B, 4, 256] (each
    image's own tables), valid [B, N] or None, n_words per image ->
    (words int32 [B, n_words], total_bits int64 [B])."""
    packs = [
        pack_scan_plain(scans[i], stride, luma_per_mcu, codes[i], lens[i], n_words,
                        None if valid is None else valid[i])
        for i in range(scans.shape[0])
    ]
    return torch.stack([w for w, _ in packs]), torch.cat([b for _, b in packs])


def _flat_tables(tables: list[tuple]) -> tuple[np.ndarray, np.ndarray]:
    """Per image (luma DC, luma AC, chroma DC, chroma AC) flat (codes[256],
    lens[256]) arrays (huffman.canonical.flat_code_arrays) -> int32 codes
    and lens [B, 4, 256]."""
    codes = np.array([[t[0] for t in image] for image in tables], dtype=np.int32)
    lens = np.array([[t[1] for t in image] for image in tables], dtype=np.int32)
    return codes, lens


def chroma_index(n_scan: int, stride: int, luma_per_mcu: int, device) -> torch.Tensor:
    """int32 [n_scan], made on the device: 1 where scan position i holds a
    chroma block (i % stride >= luma_per_mcu, stride = luma_per_mcu + 2)."""
    idx = torch.arange(n_scan, dtype=torch.int32, device=device)
    return (idx % stride >= luma_per_mcu).to(torch.int32)


def use_fused_pack() -> bool:
    """The one-call scan-pack kernel (default), or with DMMT_NO_FUSED_PACK
    set the staged route: block_emissions (lookup kernel), the
    emission-pack kernel, byteswap_words."""
    return not os.environ.get("DMMT_NO_FUSED_PACK")


def check_bits_enabled() -> bool:
    """DMMT_CHECK_BITS set: each pack's bit count is checked against the
    histograms' prediction (a debug cross-check; the tests turn it on)."""
    return bool(os.environ.get("DMMT_CHECK_BITS"))


def pack_values(tables: list[tuple], word_off) -> np.ndarray:
    """What the host gives a two-dispatch pack, as one int32 vector (one
    upload, or one copy into a program's input): per image (ldc, lac, cdc,
    cac) flat code arrays and each image's stream base in words ->
    codes [B, 4, 256], lens [B, 4, 256], word_off [B], flattened."""
    codes, lens = _flat_tables(tables)
    return np.concatenate([codes.reshape(-1), lens.reshape(-1),
                           np.asarray(word_off, dtype=np.int32)])


def unpack_values(values: torch.Tensor, n_images: int
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """pack_values' vector on the device -> (codes int32 [B, 4, 256], lens
    int32 [B, 4, 256], each image's stream base in bits, int64 [B])."""
    n = n_images * 4 * 256
    codes = values[:n].reshape(n_images, 4, 256)
    lens = values[n : 2 * n].reshape(n_images, 4, 256)
    return codes, lens, values[2 * n :].to(torch.int64) * 32


def words_capacity(needed_words: int) -> int:
    """The staged pack's word buffer for a stream of needed_words words:
    the JAX package's power-of-two bucket (bitstream/device_pack.py:
    `1 << max(12, needed.bit_length())`), so that one program serves many
    streams."""
    return 1 << max(12, int(needed_words).bit_length())


def batch_emissions(
    luma: torch.Tensor,
    cb: torch.Tensor,
    cr: torch.Tensor,
    luma_per_mcu: int,
    codes: torch.Tensor,
    lens: torch.Tensor,
    word_base: torch.Tensor,
) -> tuple[tuple[torch.Tensor, ...], torch.Tensor]:
    """The staged pack's inputs for B images: luma [B, NL, 64] and cb/cr
    [B, NC, 64] DPCM'd blocks, each image's flat code arrays codes/lens
    int32 [B, 4, 256] and its stream base in bits word_base int64 [B], all
    on the blocks' device (unpack_values) -> (block_emissions of the B
    scans, each image with its own tables; boff int64 [B * NS], each
    block's stream bit offset)."""
    b, n_chroma = int(luma.shape[0]), int(cb.shape[1])
    dev = luma.device
    # each image's MCUs are contiguous, so the batch's interleave is the
    # concatenation of the per-image interleaves
    scan = interleave_scan(luma.reshape(-1, 64), cb.reshape(-1, 64), cr.reshape(-1, 64),
                           b * n_chroma, luma_per_mcu)
    # (each image's scan is a whole number of MCUs, so position % stride
    # is the same within the batch as within the image)
    chroma = chroma_index(int(scan.shape[0]), luma_per_mcu + 2, luma_per_mcu, dev)
    table_idx = (torch.arange(b, dtype=torch.int32, device=dev)[:, None] * 2
                 + chroma.reshape(b, -1)).reshape(-1)
    dc_comb, ac_comb = _stacked_tables(codes, lens)
    emissions = block_emissions(scan, table_idx, dc_comb, ac_comb, groups=b)
    bb = emissions[3].reshape(b, -1).to(torch.int64)
    return emissions, (word_base[:, None] + _exclusive_cumsum(bb, dim=1)).reshape(-1)


def pack_enqueue(
    luma: torch.Tensor,
    cb: torch.Tensor,
    cr: torch.Tensor,
    luma_per_mcu: int,
    values: torch.Tensor,
    n_words: int,
    fused: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The second half of the two-dispatch encode, enqueued op by op: B
    images' DPCM'd blocks (luma [B, NL, 64], cb/cr [B, NC, 64]) and
    pack_values' vector on their device -> (memory-order words int32
    [n_words], total bits int64). `fused` (one image): the scan interleave,
    the scan-pack kernel and the stuffing behind it (scan_stuff.stuff_scan),
    whose stuffed length (int64 [1]) joins the outputs; else the staged
    pack (block_emissions with the lookup kernel, the emission-pack kernel
    with each image's stream at its word base, byteswap_words). What the
    pack programs capture and what the CPU runs."""
    from .emission_pack import pack_emission_words
    from .fused_pack import fused_pack_words

    codes, lens, word_base = unpack_values(values, int(luma.shape[0]))
    if fused:
        lpm = luma_per_mcu
        scan = interleave_scan(luma[0], cb[0], cr[0], int(cb.shape[1]), lpm)
        words, total_bits = fused_pack_words(scan, lpm + 2, lpm, codes[0], lens[0], n_words)
        return words, total_bits, stuff_scan(words, total_bits)
    emissions, boff = batch_emissions(luma, cb, cr, luma_per_mcu, codes, lens, word_base)
    words, total_bits = pack_emission_words(*emissions, n_words, boff=boff)
    return byteswap_words(words), total_bits


def stage_values(target: torch.Tensor, staging: torch.Tensor, host: np.ndarray) -> None:
    """Copy a host vector into a program's device input through the
    instance's own host staging buffer (pinned on a card): one write and
    one asynchronous copy on the current stream."""
    staging.numpy()[...] = host
    target.copy_(staging, non_blocking=True)


def _fill_pack(inputs: tuple, args: tuple, _maxval: int) -> None:
    """A pack program's fill: the blocks into its block inputs (device to
    device), pack_values' vector through its staging buffer."""
    *blocks, values, staging = inputs
    *sources, host = args
    for dst, src in zip(blocks, sources):
        dst.copy_(src.reshape(dst.shape))
    stage_values(values, staging, host)


def _pack_pool(kind: str, n_images: int, n_luma: int, n_chroma: int, luma_per_mcu: int,
               n_words: int, device: torch.device, fused: bool):
    """A pool of one pack program: inputs luma [B, NL, 64], cb and cr
    [B, NC, 64] (int16), pack_values' vector and its host staging;
    pack_enqueue over them."""
    n_values = n_images * (2 * 4 * 256 + 1)
    shapes = ((n_images, n_luma, 64), (n_images, n_chroma, 64), (n_images, n_chroma, 64),
              (n_values,), (n_values,))
    dtypes = (torch.int16, torch.int16, torch.int16, torch.int32, programs.HostStaging(torch.int32))

    def enqueue(inputs, _state):
        luma, cb, cr, values, _ = inputs
        return [pack_enqueue(luma, cb, cr, luma_per_mcu, values, n_words, fused)]

    return programs.pool(kind, shapes, dtypes, device, enqueue, _fill_pack)


@mode_keyed_cache(maxsize=64)
def _compiled_fused_pack(n_luma: int, n_chroma: int, luma_per_mcu: int, n_words: int,
                         device: torch.device):
    """One image's fused pack: the scan interleave and the scan-pack
    kernel. Keyed as the JAX package's program (its sweep-table sizes have
    no counterpart: the kernel holds the whole tables), plus the device;
    n_words is the worst case of the shape."""
    return _pack_pool("fused_pack", 1, n_luma, n_chroma, luma_per_mcu, n_words, device, True)


@mode_keyed_cache(maxsize=32)
def _compiled_pack(n_luma: int, n_chroma: int, luma_per_mcu: int, n_words: int,
                   device: torch.device):
    """One image's staged pack (DMMT_NO_FUSED_PACK=1), n_words a
    words_capacity bucket. Keyed as the JAX package's program, plus the
    device."""
    return _pack_pool("pack", 1, n_luma, n_chroma, luma_per_mcu, n_words, device, False)


@mode_keyed_cache(maxsize=16)
def _compiled_pack_batch(n_images: int, n_luma: int, n_chroma: int, luma_per_mcu: int,
                         words_cap: int, device: torch.device):
    """A fused_batch chunk's staged pack, words_cap a words_capacity
    bucket. Keyed as the JAX package's program, plus the device."""
    return _pack_pool("pack_batch", n_images, n_luma, n_chroma, luma_per_mcu, words_cap, device,
                      False)


def _checked_bytes(known_bits: int):
    """The read of one image's pack: with DMMT_CHECK_BITS set, the packed
    bit count against `known_bits`; then the wait for the pack
    (dmmt.pack_wait: the stream the fetch's copy would wait on) and one
    fetch (dmmt.word_fetch): the fused pack's stuffed length and that many
    stuffed bytes (their copy to host memory: dmmt.fetch_wait), which the
    host copies (dmmt.stuff > dmmt.stuff_card), or
    the needed words, which it stuffs (dmmt.stuff > dmmt.stuff_host: the
    staged pack, or a stuffed stream that had no room)."""

    def read(words: torch.Tensor, total_bits: torch.Tensor,
             stuffed: torch.Tensor | None = None) -> bytes:
        check_scan_bits(total_bits, known_bits, "device pack")
        with span("dmmt.pack_wait"):
            if words.device.type == "cuda":
                torch.cuda.current_stream(words.device).synchronize()
        with span("dmmt.word_fetch"):
            length = -1 if stuffed is None else int(stuffed)
            part = scan_fetch_slice(words, known_bits, length)
            with span("dmmt.fetch_wait"):  # the copy to host memory, which the host waits for
                host = part.cpu().numpy()
        return scan_bytes(host, known_bits, length)

    return read


def device_pack_scan(
    luma: torch.Tensor,
    cb: torch.Tensor,
    cr: torch.Tensor,
    luma_per_mcu: int,
    ldc: tuple,
    lac: tuple,
    cdc: tuple,
    cac: tuple,
    known_bits: int,
) -> bytes:
    """Pack one image's DPCM'd zigzag blocks (luma in MCU order, on their
    device) with host-built flat code arrays into stuffed scan bytes: the
    scan-pack kernel and the stuffing kernel behind it, or with
    DMMT_NO_FUSED_PACK set the staged pack (stuffed on the host).
    `known_bits` (exact_scan_bits of the histograms) is the stream length,
    so one fetch of the needed words follows the pack. With DMMT_CHECK_BITS
    set, the packed bit count is checked against it first. On a card: one
    replay of the program (_compiled_fused_pack or _compiled_pack), whose
    instance is given back after the fetch; on the CPU: pack_enqueue."""
    n_luma, n_chroma = int(luma.shape[0]), int(cb.shape[0])
    fused = use_fused_pack()
    if fused:
        n_words = (n_luma + 2 * n_chroma) * (MAX_BLOCK_BITS // 32) + 2
    else:
        n_words = words_capacity((known_bits + 31) // 32 + 2)
    values = pack_values([(ldc, lac, cdc, cac)], [0])
    read = _checked_bytes(known_bits)
    card = programs.card(luma, luma.device)
    if card is None:
        return read(*pack_enqueue(luma[None], cb[None], cr[None], luma_per_mcu,
                                  upload(values, luma.device), n_words, fused))
    cache = _compiled_fused_pack if fused else _compiled_pack
    pool = cache(n_luma, n_chroma, luma_per_mcu, n_words, card)
    return programs.run_once(pool, (luma, cb, cr, values), read)


def device_pack_scan_batch(
    luma: torch.Tensor,
    cb: torch.Tensor,
    cr: torch.Tensor,
    luma_per_mcu: int,
    tables: list[tuple],
    bits_per_image: list[int],
) -> list[bytes]:
    """Pack B images' scans in one staged pack: luma [B, NL, 64] and cb/cr
    [B, NC, 64] DPCM'd blocks on the device, per image (ldc, lac, cdc, cac)
    flat code arrays, and each image's EXACT stream bits (exact_scan_bits).
    Each image's stream starts at a word-aligned base, so one fetch of the
    first total_words words returns all streams; the word buffer is the
    JAX package's bucket of total_words + B. On a card: one replay of the
    program (_compiled_pack_batch); on the CPU: pack_enqueue."""
    b, n_luma = (int(x) for x in luma.shape[:2])
    n_chroma = int(cb.shape[1])
    n_words = [(bits + 31) // 32 for bits in bits_per_image]
    word_off = np.concatenate([[0], np.cumsum(n_words)[:-1]]).astype(np.int64)
    total_words = int(sum(n_words))
    words_cap = words_capacity(total_words + b)
    values = pack_values(tables, word_off)

    def read(words: torch.Tensor, _total_bits: torch.Tensor) -> list[bytes]:
        host = words[:total_words].cpu().numpy()
        return [
            finalize_scan_bytes(host[off : off + n], bits)
            for off, n, bits in zip(word_off, n_words, bits_per_image)
        ]

    card = programs.card(luma, luma.device)
    if card is None:
        return read(*pack_enqueue(luma, cb, cr, luma_per_mcu, upload(values, luma.device),
                                  words_cap))
    pool = _compiled_pack_batch(b, n_luma, n_chroma, luma_per_mcu, words_cap, card)
    return programs.run_once(pool, (luma, cb, cr, values), read)


def scan_fetch_slice(words: torch.Tensor, total_bits: int, stuffed: int) -> torch.Tensor:
    """What a finish fetches of a word buffer (int32 [n_words]): the
    stuffed scan the stuffing kernel left in its tail (`stuffed` bytes,
    scan_stuff.stuffed_start), or where it had no room (stuffed -1) the
    packed stream's words."""
    if stuffed >= 0:
        start = stuffed_start(total_bits)
        return words.view(torch.uint8)[start : start + stuffed]
    return words[: (int(total_bits) + 31) // 32]


def scan_bytes(host: np.ndarray, total_bits: int, stuffed: int) -> bytes:
    """The scan's bytes from scan_fetch_slice's fetch (dmmt.stuff): the
    stuffed bytes copied (dmmt.stuff_card), or the packed words stuffed here
    (dmmt.stuff_host)."""
    with span("dmmt.stuff"):
        if stuffed >= 0:
            with span("dmmt.stuff_card"):
                return host.tobytes()
        with span("dmmt.stuff_host"):
            return finalize_scan_bytes(host, total_bits)


def finalize_scan_bytes(words: np.ndarray, total_bits: int) -> bytes:
    """Host tail: trim, 1-pad the final byte, byte-stuff 0xFF -> 0xFF 0x00.

    `words` must already be in memory byte order, so this is a uint8 view
    plus the stuffing pass (pad_and_stuff). The host's fallback where the
    stuffing on the device (bitstream/scan_stuff.py) had no room, and the
    tail of the routes that do not stuff on the device."""
    n_bytes = (int(total_bits) + 7) // 8
    return pad_and_stuff(np.ascontiguousarray(words).view(np.uint8)[:n_bytes].copy(), total_bits)


def pad_and_stuff(raw: np.ndarray, total_bits: int) -> bytes:
    """A stream of total_bits bits in its ceil(total_bits / 8) bytes (uint8,
    modified in place) -> the scan's bytes: the final byte 1-padded, a 0x00
    after every 0xFF."""
    pad = len(raw) * 8 - int(total_bits)
    if pad:
        raw[-1] |= (1 << pad) - 1  # JPEG 1-padding (encoder.rs:267)
    ff = np.flatnonzero(raw == 0xFF)  # byte stuffing (segment_marker_injector.rs:14-30)
    if len(ff):
        raw = np.insert(raw, ff + 1, 0)
    return raw.tobytes()


def exact_scan_bits(
    hists: tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray],
    ldc: tuple,
    lac: tuple,
    cdc: tuple,
    cac: tuple,
) -> int:
    """EXACT total scan bit count from symbol histograms + code lengths:
    every DC/AC symbol contributes its codeword length plus its category's
    extra bits (the symbol itself for DC, its low nibble for AC). The count
    is linear in the histograms, so histograms with leading axes (one row
    per shard) give the count of their sum."""
    ldc_h, lac_h, cdc_h, cac_h = (np.asarray(h, dtype=np.int64) for h in hists)
    cats16 = np.arange(16, dtype=np.int64)
    extra256 = np.arange(256, dtype=np.int64) & 15
    total = int((ldc_h * (np.asarray(ldc[1], np.int64)[:16] + cats16)).sum())
    total += int((lac_h * (np.asarray(lac[1], np.int64) + extra256)).sum())
    total += int((cdc_h * (np.asarray(cdc[1], np.int64)[:16] + cats16)).sum())
    total += int((cac_h * (np.asarray(cac[1], np.int64) + extra256)).sum())
    return total


def check_scan_bits(packed, predicted, what: str) -> None:
    """With DMMT_CHECK_BITS set (check_bits_enabled), AssertionError unless
    a pack's bit count equals the histograms' prediction. `packed`: an int,
    or a tensor of counts, summed; `predicted`: the exact count, or
    (histograms, tables) for exact_scan_bits of the four histograms (host
    or device) with the tables' flat code arrays (HuffmanTables.flat).
    Nothing is read from the device when the check is off."""
    if not check_bits_enabled():
        return
    if isinstance(predicted, tuple):
        hists, tables = predicted
        predicted = exact_scan_bits(
            tuple(h.cpu().numpy() if isinstance(h, torch.Tensor) else h for h in hists),
            *tables.flat())
    packed = int(packed.sum()) if isinstance(packed, torch.Tensor) else int(packed)
    if packed != predicted:
        raise AssertionError(f"{what}: {packed} bits packed, but the histograms predict "
                             f"{predicted}")
