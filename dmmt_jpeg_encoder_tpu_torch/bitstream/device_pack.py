"""Entropy-scan packing in plain torch, plus the host tail.

Counterpart of dmmt_jpeg_encoder_tpu.bitstream.device_pack:

- `interleave_scan`: Y..Y Cb Cr per MCU (reference interleave,
  src/image/writer/jpeg/encoder/block_fold_iterator.rs:75-148).
- `block_emissions` + `pack_to_words` + `byteswap_words`: the scan-pack
  kernel's plain version (bitstream/fused_pack.py). Every (block, slot)
  becomes a (value, bit-length, block-relative offset) triple: 1 DC
  (codeword and magnitude bits fused), 63 AC (length 0 where the
  coefficient is zero), 3 ZRL, 1 EOB. Block offsets are an exclusive
  prefix sum; each emission lands in at most two big-endian 32-bit words,
  and bit ranges are disjoint, so adding is OR-ing. The arithmetic is
  int64 with `& 0xFFFFFFFF` where the JAX package relied on uint32
  wraparound.
- `pack_scan_slab_plain`: the slab scan-pack kernel's plain version, B
  streams of a row-stacked slab, each packed on its own (the semantics of
  the JAX package's onedispatch._tables_to_pack_slab).
- `finalize_scan_bytes` / `exact_scan_bits`: host numpy, unchanged.

Table lookups assume every symbol present in the data has a codeword,
which holds when the tables were built from this image's own histograms.
"""

from __future__ import annotations

import numpy as np
import torch

from ..entropy.categorize import magnitude_category

# Static per-block worst case: DC 31 bits, 63 AC emissions of <=31 bits,
# 3 ZRL of <=16 bits, EOB <=16 bits -> round up to 64 words.
MAX_BLOCK_BITS = 2048
_MASK32 = 0xFFFFFFFF


def interleave_scan(
    luma: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor, n_mcu: int, luma_per_mcu: int
) -> torch.Tensor:
    """[NL, 64] luma (MCU order) + [NC, 64] cb/cr -> [NL + 2NC, 64] blocks
    in scan order."""
    return torch.cat(
        [luma.reshape(n_mcu, luma_per_mcu, 64), cb[:, None, :], cr[:, None, :]], dim=1
    ).reshape(-1, 64)


def _pattern(v: torch.Tensor, cat: torch.Tensor) -> torch.Tensor:
    """JPEG magnitude bits: v for positives, one's complement for negatives
    (reference: src/...transformer/categorize.rs:45-74)."""
    return torch.where(v >= 0, v, v + (1 << cat) - 1)


def _exclusive_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.cumsum(x, dim=dim) - x


def combine_tables(codes: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """(codeword << 8 | length) combined lookup entries (int64)."""
    return (codes.to(torch.int64) << 8) | lens.to(torch.int64)


def block_emissions(
    zz: torch.Tensor,
    table_idx: torch.Tensor,
    dc_comb: torch.Tensor,
    ac_comb: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-block emission triples for scan-order blocks.

    zz: int [N, 64] zigzag coefficients (DC already DPCM).
    table_idx: [N] 0 = luma, 1 = chroma tables for the block.
    dc_comb / ac_comb: int64 [2*16] / [2*256] combined (code << 8 | len)
        entries, luma table first.

    Returns (values int64 [N, 68], lens int64 [N, 68], rel_offs int64
    [N, 68], block_bits int64 [N]).
    """
    v = zz.to(torch.int64)
    n = v.shape[0]
    cat = magnitude_category(v).to(torch.int64)
    t = table_idx.to(torch.int64)

    # --- DC ------------------------------------------------------------
    dccat = cat[:, 0]
    dc_cl = dc_comb[t * 16 + dccat]
    e_dc_val = ((dc_cl >> 8) << dccat) | _pattern(v[:, 0], dccat)
    e_dc_len = (dc_cl & 0xFF) + dccat

    # --- AC structure (categorize.rs:132-151) ---------------------------
    ac = v[:, 1:]
    accat = cat[:, 1:]
    pos = torch.arange(1, 64, dtype=torch.int64, device=v.device)[None, :]
    nz = ac != 0
    zero = torch.zeros_like(ac)
    nzpos = torch.where(nz, pos, zero)
    shifted = torch.cat([zero[:, :1], nzpos[:, :-1]], dim=1)
    run = pos - torch.cummax(shifted, dim=1).values - 1
    zrl = torch.where(nz, run >> 4, zero)
    sym = ((run & 15) << 4) | accat

    ac_cl = ac_comb[t[:, None] * 256 + sym]
    e_ac_val = torch.where(nz, ((ac_cl >> 8) << accat) | _pattern(ac, accat), zero)
    e_ac_len = torch.where(nz, (ac_cl & 0xFF) + accat, zero)

    # --- ZRL / EOB per-block constants ----------------------------------
    zrl_cl = ac_comb[t * 256 + 0xF0]
    zrl_code, zrl_len = zrl_cl >> 8, zrl_cl & 0xFF
    eob_cl = ac_comb[t * 256]
    has_eob = nzpos.amax(dim=1) < 63
    e_eob_len = torch.where(has_eob, eob_cl & 0xFF, torch.zeros_like(eob_cl))

    # --- offsets within the block ---------------------------------------
    pre = zrl * zrl_len[:, None]  # ZRL bits before each position
    seg = pre + e_ac_len
    start = e_dc_len[:, None] + _exclusive_cumsum(seg, dim=1)
    e_ac_off = start + pre
    ac_total = seg.sum(dim=1)
    e_eob_off = e_dc_len + ac_total
    block_bits = e_dc_len + ac_total + e_eob_len

    # --- the <=3 ZRL slots ----------------------------------------------
    cz = torch.cumsum(zrl, dim=1)  # inclusive count of ZRLs up to position
    cz_excl = cz - zrl
    total_z = cz[:, -1]
    zrl_vals, zrl_lens, zrl_offs = [], [], []
    for i in range(3):
        ki = torch.argmax((cz > i).to(torch.int64), dim=1, keepdim=True)
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
    offs = cols(torch.zeros(n, dtype=torch.int64, device=v.device), e_ac_off, zrl_offs, e_eob_off)
    return values, lens, offs, block_bits


def pack_to_words(
    values: torch.Tensor,
    lens: torch.Tensor,
    offs: torch.Tensor,
    block_bits: torch.Tensor,
    n_words: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter emissions into big-endian 32-bit words (logical order).

    Returns (words int64 [n_words] holding uint32 values, total_bits int64
    scalar tensor)."""
    block_off = _exclusive_cumsum(block_bits, dim=0)
    total_bits = block_off[-1] + block_bits[-1]

    goff = (block_off[:, None] + offs).reshape(-1)
    val = values.reshape(-1)
    ln = lens.reshape(-1)

    w0 = goff >> 5
    end = (goff & 31) + ln
    # An emission occupies bits [b0, end) of (w0, w0 + 1), MSB first.
    spill = torch.clamp(end - 32, min=0)
    zero = torch.zeros_like(val)
    c0 = torch.where(ln > 0, ((val >> spill) << torch.clamp(32 - end, min=0)) & _MASK32, zero)
    c1 = torch.where(spill > 0, (val << (32 - spill)) & _MASK32, zero)

    words = torch.zeros(n_words + 1, dtype=torch.int64, device=val.device)
    keep = ln > 0
    words.index_add_(0, w0[keep], c0[keep])
    words.index_add_(0, w0[keep] + 1, c1[keep])
    return words[:n_words], total_bits


def byteswap_words(words: torch.Tensor) -> torch.Tensor:
    """Logical big-endian uint32 words (int64 tensor) -> memory-order words
    as int32 (the bit pattern of the uint32, so a uint8 view of the buffer
    is the stream)."""
    w = words & _MASK32
    swapped = ((w & 0xFF) << 24) | ((w & 0xFF00) << 8) | ((w >> 8) & 0xFF00) | (w >> 24)
    return torch.where(swapped >= 1 << 31, swapped - (1 << 32), swapped).to(torch.int32)


def pack_scan_plain(
    scan: torch.Tensor,
    stride: int,
    luma_per_mcu: int,
    codes_flat: torch.Tensor,
    lens_flat: torch.Tensor,
    n_words: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The scan-pack kernel's plain version, same contract: scan-order
    blocks [N, 64] (block i is chroma iff i % stride >= luma_per_mcu) and
    the four flat tables [4, 256] (luma DC, luma AC, chroma DC, chroma AC)
    -> (memory-order words int32 [n_words], total_bits int64 [1])."""
    n = scan.shape[0]
    idx = torch.arange(n, device=scan.device)
    table_idx = (idx % stride >= luma_per_mcu).to(torch.int64)
    comb = combine_tables(codes_flat, lens_flat)
    dc_comb = torch.cat([comb[0, :16], comb[2, :16]])
    ac_comb = torch.cat([comb[1], comb[3]])
    values, lens, offs, block_bits = block_emissions(scan, table_idx, dc_comb, ac_comb)
    words, total_bits = pack_to_words(values, lens, offs, block_bits, n_words)
    return byteswap_words(words), total_bits.reshape(1)


def pack_scan_slab_plain(
    scans: torch.Tensor,
    stride: int,
    luma_per_mcu: int,
    codes: torch.Tensor,
    lens: torch.Tensor,
    n_words: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The slab scan-pack kernel's plain version: B independent streams,
    each packed exactly as pack_scan_plain packs it alone. scans [B, N, 64]
    (one image's scan-order blocks each), codes/lens [B, 4, 256] (each
    image's own tables), n_words per image -> (words int32 [B, n_words],
    total_bits int64 [B])."""
    packs = [
        pack_scan_plain(scans[i], stride, luma_per_mcu, codes[i], lens[i], n_words)
        for i in range(scans.shape[0])
    ]
    return torch.stack([w for w, _ in packs]), torch.cat([b for _, b in packs])


def finalize_scan_bytes(words: np.ndarray, total_bits: int) -> bytes:
    """Host tail: trim, 1-pad the final byte, byte-stuff 0xFF -> 0xFF 0x00.

    `words` must already be in memory byte order, so this is a uint8 view
    plus the stuffing pass."""
    n_bytes = (int(total_bits) + 7) // 8
    raw = np.ascontiguousarray(words).view(np.uint8)[:n_bytes].copy()
    pad = n_bytes * 8 - int(total_bits)
    if pad:
        raw[-1] |= (1 << pad) - 1  # JPEG 1-padding (encoder.rs:267)
    ff = np.flatnonzero(raw == 0xFF)
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
    extra bits (the symbol itself for DC, its low nibble for AC)."""
    ldc_h, lac_h, cdc_h, cac_h = (np.asarray(h, dtype=np.int64) for h in hists)
    cats16 = np.arange(16, dtype=np.int64)
    extra256 = np.arange(256, dtype=np.int64) & 15
    total = int((ldc_h * (np.asarray(ldc[1], np.int64)[:16] + cats16)).sum())
    total += int((lac_h * (np.asarray(lac[1], np.int64) + extra256)).sum())
    total += int((cdc_h * (np.asarray(cdc[1], np.int64)[:16] + cats16)).sum())
    total += int((cac_h * (np.asarray(cac[1], np.int64) + extra256)).sum())
    return total
