"""Debug tooling: independent JPEG parsing/decoding for verification.

The reference ships a debug Huffman tree decoder "for debugging not for
speed" (reference: src/huffman/tree.rs:155-204) and verified bitstreams by
hand (tests/decoding.txt). This package goes further: a complete baseline
JPEG parser + decoder, so tests can round-trip the encoder's output without
trusting any external library.
"""
