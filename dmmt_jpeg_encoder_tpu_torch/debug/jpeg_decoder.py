"""A small, strict baseline-JPEG decoder (host, numpy).

Purpose-built verifier for this encoder's output: parses the JFIF container
segment by segment (asserting the structural invariants the encoder
guarantees), entropy-decodes the interleaved scan with canonical Huffman
tables, undoes DPCM/zigzag/quantization, applies the float IDCT, upsamples
chroma, and converts back to RGB. No external codec involved — this is the
ground-truth oracle for round-trip tests and a bitstream inspector for
debugging (the deep end of the reference's segment-hexdump logging and
tests/decoding.txt hand-decode worksheet).

The port's copy of dmmt_jpeg_encoder_tpu.debug.jpeg_decoder: the same
parse and the same float64 arithmetic (IDCT matrix, order of operations,
rounding), so it decodes to the same arrays. Its entropy decoder looks
each symbol up from a 16-bit window of the stream instead of walking the
code bit by bit, and it runs the IDCT over all blocks of a component in
one batched product. The card's machine has no PIL: this is the decoder
that checks the port's JPEGs there.

Only what the encoder emits is supported: SOI, APP0, DQT (8-bit, one table
per segment), SOF0 (3 components), DHT (one table per segment), SOS
(interleaved, full spectral range), EOI, no restart markers.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..tables import ZIGZAG


@dataclass
class _Component:
    cid: int
    h: int
    v: int
    tq: int
    td: int = 0
    ta: int = 0


@dataclass
class ParsedJpeg:
    width: int = 0
    height: int = 0
    precision: int = 8
    quant: dict = field(default_factory=dict)        # id -> uint8[64] raster
    huffman: dict = field(default_factory=dict)      # (class, id) -> {code: (len, symbol)}
    components: list = field(default_factory=list)   # [_Component]
    scan_data: bytes = b""
    segments: list = field(default_factory=list)     # [(marker, length)] in order


def _build_huffman(counts: list[int], symbols: list[int]) -> dict:
    """(length, code) -> symbol from the DHT counts/symbols lists (the
    canonical reconstruction every JPEG decoder performs)."""
    table = {}
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            table[(length, code)] = symbols[k]
            code += 1
            k += 1
        code <<= 1
    return table


def parse_jpeg(data: bytes) -> ParsedJpeg:
    out = ParsedJpeg()
    if data[:2] != b"\xff\xd8":
        raise ValueError("missing SOI")
    out.segments.append(("SOI", 0))
    i = 2
    while i < len(data):
        if data[i] != 0xFF:
            raise ValueError(f"expected marker at {i}")
        marker = data[i + 1]
        if marker == 0xD9:
            out.segments.append(("EOI", 0))
            break
        length = int.from_bytes(data[i + 2 : i + 4], "big")
        seg = data[i + 4 : i + 2 + length]
        if marker == 0xE0:
            out.segments.append(("APP0", length))
        elif marker == 0xDB:
            out.segments.append(("DQT", length))
            tid = seg[0] & 0x0F
            if seg[0] >> 4:
                raise ValueError("16-bit quant tables unsupported")
            zz = np.frombuffer(seg[1:65], dtype=np.uint8)
            raster = np.zeros(64, np.uint8)
            raster[ZIGZAG] = zz
            out.quant[tid] = raster
        elif marker == 0xC0:
            out.segments.append(("SOF0", length))
            out.precision = seg[0]
            out.height = int.from_bytes(seg[1:3], "big")
            out.width = int.from_bytes(seg[3:5], "big")
            n = seg[5]
            for c in range(n):
                cid, hv, tq = seg[6 + 3 * c : 9 + 3 * c]
                out.components.append(_Component(cid, hv >> 4, hv & 15, tq))
        elif marker == 0xC4:
            out.segments.append(("DHT", length))
            tc, th = seg[0] >> 4, seg[0] & 15
            counts = list(seg[1:17])
            symbols = list(seg[17 : 17 + sum(counts)])
            out.huffman[(tc, th)] = _build_huffman(counts, symbols)
        elif marker == 0xDA:
            out.segments.append(("SOS", length))
            ns = seg[0]
            for c in range(ns):
                cid, tables = seg[1 + 2 * c : 3 + 2 * c]
                comp = next(x for x in out.components if x.cid == cid)
                comp.td, comp.ta = tables >> 4, tables & 15
            # entropy data runs to EOI; un-stuff 0xFF00
            j = i + 2 + length
            scan = bytearray()
            while j < len(data) - 1:
                if data[j] == 0xFF:
                    if data[j + 1] == 0x00:
                        scan.append(0xFF)
                        j += 2
                        continue
                    break  # a real marker (EOI)
                scan.append(data[j])
                j += 1
            out.scan_data = bytes(scan)
            i = j
            continue
        else:
            out.segments.append((f"0x{marker:02X}", length))
        i += 2 + length
    return out


class _BitReader:
    """MSB-first reader over the unstuffed scan. Reads past the end see 0
    bits; a well-formed scan never needs them."""

    def __init__(self, data: bytes):
        self.data = data + b"\0\0\0\0"
        self.pos = 0

    def peek16(self) -> int:
        byte = self.pos >> 3
        return (int.from_bytes(self.data[byte : byte + 3], "big") >> (8 - (self.pos & 7))) & 0xFFFF

    def bits(self, n: int) -> int:
        byte, off = self.pos >> 3, self.pos & 7
        self.pos += n
        return (int.from_bytes(self.data[byte : byte + 4], "big") >> (32 - off - n)) & ((1 << n) - 1)


def _window_table(table: dict) -> list:
    """(length, code) -> symbol as a 2^16-entry list: a 16-bit window of
    the stream -> (length, symbol) of the code it starts with, or None.
    The codes are prefix-free, so this decodes as the bit-by-bit walk
    does, one lookup per symbol."""
    window = [None] * (1 << 16)
    for (length, code), symbol in table.items():
        span = 1 << (16 - length)
        window[code * span : (code + 1) * span] = [(length, symbol)] * span
    return window


def _decode_symbol(r: _BitReader, window: list) -> int:
    entry = window[r.peek16()]
    if entry is None:
        raise ValueError("invalid Huffman code")
    r.pos += entry[0]
    return entry[1]


def _extend(v: int, cat: int) -> int:
    """Magnitude bits -> signed value (JPEG EXTEND)."""
    if cat == 0:
        return 0
    return v if v >= (1 << (cat - 1)) else v - (1 << cat) + 1


def _idct_matrix() -> np.ndarray:
    c = np.zeros((8, 8))
    for k in range(8):
        s = np.sqrt(1 / 8) if k == 0 else 0.5
        for n in range(8):
            c[k, n] = s * np.cos((2 * n + 1) * k * np.pi / 16)
    return c


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> uint8 RGB [H, W, 3]. Baseline interleaved 3-component
    only (exactly what this encoder produces)."""
    p = parse_jpeg(data)
    hmax = max(c.h for c in p.components)
    vmax = max(c.v for c in p.components)
    mcu_w, mcu_h = 8 * hmax, 8 * vmax
    mcus_x = -(-p.width // mcu_w)
    mcus_y = -(-p.height // mcu_h)

    # each component's zigzag coefficients by (MCU row, MCU column, block
    # row, block column)
    zzs = [np.zeros((mcus_y, mcus_x, c.v, c.h, 64), np.float64) for c in p.components]
    pred = [0] * len(p.components)
    r = _BitReader(p.scan_data)
    windows = {key: _window_table(table) for key, table in p.huffman.items()}

    for my in range(mcus_y):
        for mx in range(mcus_x):
            for ci, comp in enumerate(p.components):
                dc_tab = windows[(0, comp.td)]
                ac_tab = windows[(1, comp.ta)]
                for by in range(comp.v):
                    for bx in range(comp.h):
                        zz = zzs[ci][my, mx, by, bx]
                        cat = _decode_symbol(r, dc_tab)
                        diff = _extend(r.bits(cat), cat)
                        pred[ci] += diff
                        zz[0] = pred[ci]
                        k = 1
                        while k < 64:
                            sym = _decode_symbol(r, ac_tab)
                            if sym == 0x00:
                                break
                            run, acat = sym >> 4, sym & 15
                            if acat == 0 and run == 15:
                                k += 16
                                continue
                            k += run
                            zz[k] = _extend(r.bits(acat), acat)
                            k += 1

    # dequantize and IDCT every block of a component at once (per block
    # the same products and matrix products as one at a time)
    idct = _idct_matrix()
    planes = []
    for c, zz in zip(p.components, zzs):
        q = p.quant[c.tq].astype(np.float64)
        coeffs = np.zeros((zz[..., 0].size, 64), np.float64)
        coeffs[:, ZIGZAG] = zz.reshape(-1, 64) * q[ZIGZAG]
        blocks = idct.T @ coeffs.reshape(-1, 8, 8) @ idct
        planes.append(blocks.reshape(mcus_y, mcus_x, c.v, c.h, 8, 8)
                      .transpose(0, 2, 4, 1, 3, 5)
                      .reshape(mcus_y * c.v * 8, mcus_x * c.h * 8))

    # upsample chroma to luma geometry (nearest, matching the subsampling)
    yh, yw = mcus_y * vmax * 8, mcus_x * hmax * 8
    full = []
    for c, plane in zip(p.components, planes):
        if c.h != hmax or c.v != vmax:
            plane = np.repeat(np.repeat(plane, vmax // c.v, 0), hmax // c.h, 1)
        full.append(plane[:yh, :yw])
    y, cb, cr = full
    # invert the encoder's signed-chroma convention (color.rs:75-100):
    # y in [-128,127] -> +128; cb/cr carried signed
    r_ = y + 128 + 1.402 * cr
    g_ = y + 128 - 0.344136 * cb - 0.714136 * cr
    b_ = y + 128 + 1.772 * cb
    rgb = np.stack([r_, g_, b_], axis=-1)
    return np.clip(np.round(rgb), 0, 255).astype(np.uint8)[: p.height, : p.width]
