"""Huffman table construction: host code-length lists (spec, package_merge,
canonical), the on-device batched build (device_tables), and the debug
tree (tree) and canonical-code decoder (decoder)."""

from .decoder import HuffmanDecoder

__all__ = ["HuffmanDecoder"]
