"""Debug Huffman decoder for round-trip tests.

The reference carries an explicit tree decoder "for debugging not for speed"
(reference: src/huffman/tree.rs:155-204). We provide the same capability as
a canonical-code bit-walk over the (symbol, length) lists, which decodes any
stream produced by canonical_codes()/the scan packer.
"""

from __future__ import annotations

from ..errors import HuffmanError
from .canonical import canonical_codes
from .spec import SymbolCodeLength


class HuffmanDecoder:
    def __init__(self, code_lengths: list[SymbolCodeLength]):
        self._by_len_pattern: dict[tuple[int, int], int] = {}
        self.max_len = 0
        for sym, cw in canonical_codes(code_lengths).items():
            self._by_len_pattern[(cw.length, cw.bits)] = sym
            self.max_len = max(self.max_len, cw.length)

    def decode_symbol(self, reader: "BitReader") -> int:
        code = 0
        for length in range(1, self.max_len + 1):
            code = (code << 1) | reader.read_bit()
            sym = self._by_len_pattern.get((length, code))
            if sym is not None:
                return sym
        raise HuffmanError(f"invalid codeword prefix {code:b}")

    def decode_sequence(self, data: bytes, count: int) -> list[int]:
        reader = BitReader(data)
        return [self.decode_symbol(reader) for _ in range(count)]


class BitReader:
    """MSB-first bit reader over bytes."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0  # bit position

    def read_bit(self) -> int:
        byte_index, bit_index = divmod(self.pos, 8)
        if byte_index >= len(self.data):
            raise HuffmanError("bit stream exhausted")
        self.pos += 1
        return (self.data[byte_index] >> (7 - bit_index)) & 1

    def read_bits(self, n: int) -> int:
        value = 0
        for _ in range(n):
            value = (value << 1) | self.read_bit()
        return value
