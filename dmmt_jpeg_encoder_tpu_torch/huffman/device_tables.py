"""Huffman table construction on the device, in plain torch.

The counterpart of dmmt_jpeg_encoder_tpu.huffman.device_tables
(`device_code_tables_batched`, `pad_dc_histogram`): histograms -> code
tables without a host round trip, bit-identical to the host build in
huffman/spec.py + package_merge.py + canonical.py:

- stable ascending-frequency sort with ties in symbol order
  (reference: src/...transformer/symbol_counting.rs:92-94);
- package-merge levels with Leaf < Package on equal frequency (sort key
  value*2 + kind) and chunks-of-2 merging (src/huffman/length_limited.rs);
- the `lengths[0] += 1` all-ones bump;
- canonical codewords assigned shortest-first (src/huffman/encoder.rs).

Stable sorts with payloads are `torch.sort(stable=True)` indices plus
gathers. Package values clamp at INF = 2**28, so per-table symbol totals
must stay below 2**28 for exact tie-breaking (onedispatch.py guards it).
"""

from __future__ import annotations

import torch

LIMIT = 15
NSYM = 256          # histogram width (DC histograms are padded to 256)
LEVEL = 2 * NSYM    # a package-merge level holds <= 2n entries
INF = 1 << 28       # > any real frequency sum; INF+INF clamps back to INF


def device_code_tables_batched(hists: torch.Tensor) -> dict[str, torch.Tensor]:
    """[G, 256] integer histograms -> per-table code data on hists' device.

    Returns a dict of int32 tensors:
      sym_by_leaf  [G, 256]: symbols sorted ascending by (freq, symbol)
      len_by_leaf  [G, 256]: code lengths per leaf (0 beyond n_present);
                   leaf 0 = least frequent = longest code (+1 bump applied)
      n_present    [G]     : number of symbols with freq > 0
      codes_flat   [G, 256]: right-aligned codeword per SYMBOL (0 absent)
      lens_flat    [G, 256]: code length per SYMBOL (0 absent)
    """
    dev = hists.device
    g = hists.shape[0]
    i32 = torch.int32
    freq = hists.to(i32)
    present = freq > 0
    n = present.sum(dim=1, dtype=i32)
    inf = torch.full((), INF, dtype=i32, device=dev)  # a fill, not a blocking upload

    key = torch.where(present, freq, inf)
    sorted_freq, order = torch.sort(key, dim=1, stable=True)
    sorted_sym = order.to(i32)
    leaf_rank = torch.arange(NSYM, dtype=i32, device=dev).expand(g, NSYM)
    leaf_valid = leaf_rank < n[:, None]

    # --- package-merge levels (length_limited.rs:63-115) -----------------
    leaves_v = torch.cat(
        [torch.where(leaf_valid, sorted_freq, inf),
         torch.full((g, LEVEL - NSYM), INF, dtype=i32, device=dev)], dim=1
    )
    merged_k = torch.cat(
        [torch.ones((g, LEVEL // 2), dtype=i32, device=dev),
         torch.zeros((g, NSYM), dtype=i32, device=dev)], dim=1
    )
    level_v = leaves_v
    kinds = [torch.zeros((g, LEVEL), dtype=i32, device=dev)]
    for _ in range(1, LIMIT):
        pair_v = torch.minimum(level_v[:, 0::2] + level_v[:, 1::2], inf)
        merged_v = torch.cat([pair_v, leaves_v[:, :NSYM]], dim=1)
        _, idx = torch.sort(merged_v * 2 + merged_k, dim=1, stable=True)
        level_v = merged_v.gather(1, idx)
        kinds.append(merged_k.gather(1, idx))

    # --- solution walk (length_limited.rs:75-89) -------------------------
    idx = torch.arange(LEVEL, dtype=i32, device=dev).expand(g, LEVEL)
    p = n - 1  # num_packages; n == 1 -> 0 -> all lengths stay 0
    len_by_leaf = torch.zeros((g, NSYM), dtype=i32, device=dev)
    for level_kind in reversed(kinds):
        taken = idx < 2 * p[:, None]
        leaves_taken = (taken & (level_kind == 0)).sum(dim=1, dtype=i32)
        p = taken.sum(dim=1, dtype=i32) - leaves_taken
        len_by_leaf = len_by_leaf + (leaf_rank < leaves_taken[:, None]).to(i32)

    # the all-ones bump: the longest code (leaf 0) gets +1 when any symbol exists
    len_by_leaf[:, 0] += (n > 0).to(i32)
    len_by_leaf = torch.where(leaf_valid, len_by_leaf, torch.zeros_like(len_by_leaf))

    # --- canonical codes (encoder.rs:97-119) -----------------------------
    # Walking shortest (leaf n-1) to longest (leaf 0), each step adds
    # 1 << (16 - prev_len) in MSB-aligned space: in leaf order, a reversed
    # exclusive suffix sum of the per-leaf increments.
    one = torch.ones_like(len_by_leaf)
    zero = torch.zeros_like(len_by_leaf)
    contrib = torch.where(leaf_valid, one << (16 - len_by_leaf), zero)
    cum = torch.cumsum(contrib, dim=1, dtype=i32)
    pattern = cum[:, NSYM - 1 :] - cum  # sum over the leaves AFTER this one
    bits = torch.where(leaf_valid, pattern >> (16 - len_by_leaf), zero)

    order = order.long()
    codes_flat = zero.scatter(1, order, bits)
    lens_flat = zero.scatter(1, order, len_by_leaf)
    return {
        "sym_by_leaf": sorted_sym,
        "len_by_leaf": len_by_leaf,
        "n_present": n,
        "codes_flat": codes_flat,
        "lens_flat": lens_flat,
    }


def pad_dc_histogram(dc_hist: torch.Tensor) -> torch.Tensor:
    """16-bin DC histogram -> 256-bin (one shared table-build path)."""
    pad = torch.zeros(NSYM - dc_hist.shape[0], dtype=torch.int32, device=dc_hist.device)
    return torch.cat([dc_hist.to(torch.int32), pad])
