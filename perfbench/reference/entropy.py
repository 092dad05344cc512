"""Plain entropy coding of the reference encoder: blocks -> tables -> scan bytes.

The table construction is a frozen copy of the PyTorch port at commit
403a63c (dmmt_jpeg_encoder_tpu_torch: huffman/spec.py,
huffman/package_merge.py, huffman/canonical.py `canonical_codes`,
`dht_payload`, bitstream/device_pack.py `finalize_scan_bytes`), which
replicates the reference encoder's package-merge and its tie-breaking.
The histograms and the scan emission are written here, in plain torch,
from the JPEG baseline rules (ITU-T T.81, F.1.2): per block a DC category
code with its extra bits, then for each nonzero AC coefficient one ZRL
code per 16 zeros before it and a run/size code with its extra bits, and
an EOB where the block ends in zeros; MCUs interleave the luma blocks
with one Cb and one Cr block; the stream is 1-padded and 0xFF is
stuffed with 0x00.
"""

from __future__ import annotations

import numpy as np
import torch

_LEAF, _PACKAGE = 0, 1


def _category(v: torch.Tensor) -> torch.Tensor:
    """Magnitude category (bit length of |v|, 0 for 0) of int values below
    2**24, int64."""
    return torch.frexp(v.abs().to(torch.float32)).exponent.to(torch.int64)


def _ac_structure(blocks: torch.Tensor):
    """For [N, 64] zigzag blocks: (nonzero mask [N, 63], run of zeros
    before each AC coefficient [N, 63], whether each block ends in an EOB)."""
    ac = blocks[:, 1:].to(torch.int64)
    pos = torch.arange(1, 64, device=blocks.device)[None, :]
    nz = ac != 0
    nzpos = torch.where(nz, pos, torch.zeros_like(ac))
    prev = torch.cummax(torch.cat([torch.zeros_like(ac[:, :1]), nzpos[:, :-1]], dim=1), dim=1).values
    return nz, pos - prev - 1, nzpos.amax(dim=1) < 63


def histograms(blocks: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """(DC histogram [16], AC histogram [256]) of DPCM'd zigzag blocks."""
    dc = torch.bincount(_category(blocks[:, 0]), minlength=16)
    nz, run, eob = _ac_structure(blocks)
    sym = ((run & 15) << 4) | _category(blocks[:, 1:])
    ac = torch.bincount(sym[nz], minlength=256)
    ac[0xF0] += (run[nz] >> 4).sum()
    ac[0x00] += eob.sum()
    return dc.cpu().numpy(), ac.cpu().numpy()


def package_merge_lengths(freqs: list[int], limit: int) -> list[int]:
    """Length-limited code lengths for frequencies sorted ascending; index 0
    (least frequent) gets the longest code. Nodes order as (frequency,
    kind), a leaf before a package of equal frequency."""
    n = len(freqs)
    leaves = [(f, _LEAF) for f in freqs]
    levels = [list(leaves)]
    for _ in range(1, limit):
        prev = levels[-1]
        merged = [(prev[i][0] + prev[i + 1][0], _PACKAGE) for i in range(0, len(prev) - 1, 2)]
        levels.append(sorted(merged + leaves))
    lengths = [0] * n
    packages = n - 1
    for level in reversed(levels):
        taken = level[: 2 * packages]
        n_leaves = sum(1 for _, kind in taken if kind == _LEAF)
        packages = len(taken) - n_leaves
        for i in range(n_leaves):
            lengths[i] += 1
    return lengths


def code_lengths(histogram: np.ndarray) -> list[tuple[int, int]]:
    """(symbol, code length) pairs, descending length: the nonzero counts
    stable-sorted ascending, package-merge limited to 15 bits, then the
    longest code extended by one bit (no all-ones codeword)."""
    pairs = sorted(((s, int(f)) for s, f in enumerate(histogram) if f > 0), key=lambda p: p[1])
    if not pairs:
        return []
    lengths = package_merge_lengths([f for _, f in pairs], 15)
    out = [[s, n] for (s, _), n in zip(pairs, lengths)]
    out[0][1] += 1
    return [(s, n) for s, n in out]


def canonical_codes(lengths: list[tuple[int, int]]) -> tuple[np.ndarray, np.ndarray]:
    """(codes [256], lengths [256]) right-aligned: the shortest code is all
    zeros, each next one adds 1 << (16 - previous length) in 16-bit
    MSB-aligned space, walking the list from its end."""
    codes, lens = np.zeros(256, np.int64), np.zeros(256, np.int64)
    pattern, prev = 0, None
    for sym, n in reversed(lengths):
        if prev is not None:
            pattern += 1 << (16 - prev)
        codes[sym], lens[sym] = pattern >> (16 - n), n
        prev = n
    return codes, lens


def dht_payload(class_and_id: int, lengths: list[tuple[int, int]]) -> bytes:
    counts = [0] * 16
    for _, n in lengths:
        counts[n - 1] += 1
    return bytes([class_and_id, *counts, *(s for s, _ in reversed(lengths))])


def scan_bytes(luma: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor, lpm: int,
               luma_codes: tuple, chroma_codes: tuple) -> bytes:
    """The entropy-coded scan of one image. `*_codes`: (dc codes, dc
    lengths, ac codes, ac lengths) numpy [256] each."""
    dev = luma.device
    n_mcu = int(cb.shape[0])
    scan = torch.cat([luma.reshape(n_mcu, lpm, 64), cb[:, None], cr[:, None]], dim=1).reshape(-1, 64)
    chroma = torch.zeros(n_mcu, lpm + 2, dtype=torch.bool, device=dev)
    chroma[:, lpm:] = True
    table = chroma.reshape(-1).to(torch.int64)  # 0 luma, 1 chroma, per block
    dc_codes, dc_lens, ac_codes, ac_lens = (
        torch.from_numpy(np.stack([lu, ch])).to(dev)
        for lu, ch in zip(luma_codes, chroma_codes))
    n = int(scan.shape[0])
    blk = torch.arange(n, device=dev)

    def coded(t, codes, lens, sym, cat, v):
        """One item per symbol: its code followed by the value's `cat` low
        bits (negative values as v - 1), and its length."""
        extra = torch.where(v < 0, v + (1 << cat) - 1, v) & ((1 << cat) - 1)
        return (codes[t, sym] << cat) | extra, lens[t, sym] + cat

    keys, vals, lens = [], [], []
    dc = scan[:, 0].to(torch.int64)
    cat = _category(dc)
    val, ln = coded(table, dc_codes, dc_lens, cat, cat, dc)
    keys.append(blk * 256)
    vals.append(val)
    lens.append(ln)
    nz, run, eob = _ac_structure(scan)
    b_idx, p_idx = nz.nonzero(as_tuple=True)
    ac = scan[:, 1:].to(torch.int64)[b_idx, p_idx]
    r = run[b_idx, p_idx]
    t = table[b_idx]
    cat = _category(ac)
    val, ln = coded(t, ac_codes, ac_lens, ((r & 15) << 4) | cat, cat, ac)
    keys.append(b_idx * 256 + 4 * (p_idx + 1) + 3)
    vals.append(val)
    lens.append(ln)
    for j in range(3):  # ZRL items: at most 3 before a coefficient (62 zeros)
        m = (r >> 4) > j
        keys.append(b_idx[m] * 256 + 4 * (p_idx[m] + 1) + j)
        vals.append(ac_codes[t[m], 0xF0])
        lens.append(ac_lens[t[m], 0xF0])
    e = eob.nonzero(as_tuple=True)[0]
    keys.append(e * 256 + 255)
    vals.append(ac_codes[table[e], 0x00])
    lens.append(ac_lens[table[e], 0x00])
    order = torch.argsort(torch.cat(keys))
    vals, lens = torch.cat(vals)[order], torch.cat(lens)[order]
    total = int(lens.sum())
    n_bytes = (total + 7) // 8
    starts = torch.cumsum(lens, 0) - lens
    item = torch.repeat_interleave(torch.arange(int(lens.shape[0]), device=dev), lens)
    offset = torch.arange(total, device=dev) - starts[item]
    bits = torch.ones(n_bytes * 8, dtype=torch.int64, device=dev)  # 1-padded
    bits[:total] = (vals[item] >> (lens[item] - 1 - offset)) & 1
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int64, device=dev)
    raw = (bits.reshape(-1, 8) * weights).sum(dim=1).to(torch.uint8).cpu().numpy()
    ff = np.flatnonzero(raw == 0xFF)
    if len(ff):
        raw = np.insert(raw, ff + 1, 0)
    return raw.tobytes()
