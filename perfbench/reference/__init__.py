"""The benchmark's plain reference encoder: RGB samples -> baseline JFIF bytes.

Plain torch and numpy, importing nothing of the program under test and
nothing of JAX. Its bytes are the contract the program is held to: equal,
for the configurations the benchmark runs (ARAI DCT, Annex K tables with
optional quality scaling), to the JAX package's encode_array
(`perfbench/tests/test_perfbench_reference.py` holds it against the
JAX-made goldens). It runs on any torch device; on a card it takes tens
of milliseconds per 4K frame.
"""

from __future__ import annotations

import numpy as np
import torch

from . import entropy, jfif, phase1


def encode(pixels: np.ndarray, maxval: int, config: dict, device="cpu",
           precision: str = "float32") -> bytes:
    """One JPEG of integer RGB [H, W, 3] samples under `config` (the keys
    chroma_subsampling, quantization_preset, quality, bits_per_channel of a
    configuration file)."""
    preset = config["chroma_subsampling"]
    luma_q, chroma_q = jfif.quantization_tables(config["quantization_preset"], config["quality"])
    dtype = np.uint8 if maxval <= 255 else np.uint16
    rgb = torch.from_numpy(np.ascontiguousarray(pixels.astype(dtype, copy=False))).to(device)
    luma, cb, cr = phase1.zigzag_blocks(rgb, maxval, luma_q, chroma_q, preset, precision)
    l_dc, l_ac = entropy.histograms(luma)
    c_dc, c_ac = entropy.histograms(torch.cat([cb, cr]))
    tables = [entropy.code_lengths(h) for h in (l_dc, l_ac, c_dc, c_ac)]
    codes = [entropy.canonical_codes(t) for t in tables]
    hr, vr = phase1.RATES[preset]
    scan = entropy.scan_bytes(luma, cb, cr, hr * vr, (*codes[0], *codes[1]), (*codes[2], *codes[3]))
    return jfif.assemble(int(pixels.shape[1]), int(pixels.shape[0]), config["bits_per_channel"],
                         preset, luma_q, chroma_q, tables, scan)
