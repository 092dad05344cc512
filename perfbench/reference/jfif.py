"""Quantization tables and the JFIF container of the reference encoder.

A frozen copy of the PyTorch port at commit 403a63c
(dmmt_jpeg_encoder_tpu_torch: tables.py `SPECIFICATION_*` and
`quantization_table_pair`, container.py `assemble_jpeg`), cut to the
one preset the configurations use (ITU-T T.81 Annex K) with the IJG
quality scaling. Segments: SOI, APP0 (JFIF 1.02), DQT luma and chroma
(zigzag order), SOF0, DHT luma AC, luma DC, chroma AC, chroma DC, SOS,
the scan, EOI.
"""

from __future__ import annotations

import numpy as np

from .entropy import dht_payload
from .phase1 import RATES, ZIGZAG

SPECIFICATION_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
], dtype=np.uint8)
SPECIFICATION_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    *([99] * 32),
], dtype=np.uint8)
PRESETS = {"SPECIFICATION": (SPECIFICATION_LUMA, SPECIFICATION_CHROMA)}


def quantization_tables(preset: str, quality: int | None) -> tuple[np.ndarray, np.ndarray]:
    """(luma, chroma) raster uint8 [64]; `quality` scales by 5000 / q % below
    50 and by 200 - 2q % from 50, clamped to 1..255."""
    luma, chroma = PRESETS[preset]
    if quality is None:
        return luma.copy(), chroma.copy()
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return tuple(np.clip((t.astype(np.int64) * scale + 50) // 100, 1, 255).astype(np.uint8)
                 for t in (luma, chroma))


def _segment(marker: int, content: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(content) + 2).to_bytes(2, "big") + content


def assemble(width: int, height: int, bits: int, preset: str, luma_q: np.ndarray,
             chroma_q: np.ndarray, tables: list, scan: bytes) -> bytes:
    """The JFIF file; `tables`: the (symbol, length) lists luma DC, luma AC,
    chroma DC, chroma AC."""
    hr, vr = RATES[preset]
    l_dc, l_ac, c_dc, c_ac = tables
    return b"".join([
        b"\xff\xd8",
        _segment(0xE0, b"JFIF\x00\x01\x02\x00\x00\x48\x00\x48\x00\x00"),
        _segment(0xDB, bytes([0]) + np.asarray(luma_q, np.uint8)[ZIGZAG].tobytes()),
        _segment(0xDB, bytes([1]) + np.asarray(chroma_q, np.uint8)[ZIGZAG].tobytes()),
        _segment(0xC0, bytes([bits, height >> 8, height & 0xFF, width >> 8, width & 0xFF, 3,
                              1, (hr << 4) | vr, 0, 2, 0x11, 1, 3, 0x11, 1])),
        _segment(0xC4, dht_payload(0x11, l_ac)),
        _segment(0xC4, dht_payload(0x00, l_dc)),
        _segment(0xC4, dht_payload(0x13, c_ac)),
        _segment(0xC4, dht_payload(0x02, c_dc)),
        _segment(0xDA, bytes([3, 1, 0x01, 2, 0x23, 3, 0x23, 0, 0x3F, 0])),
        scan,
        b"\xff\xd9",
    ])
