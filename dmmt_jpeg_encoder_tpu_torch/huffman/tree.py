"""Explicit Huffman tree: build, one-star replacement, ASCII display, and a
bit-walk decoder.

Debug/inspection machinery matching the reference's tree module
(reference: src/huffman/tree.rs:21-284). Not on the encode path — the
production tables go histogram -> package-merge -> canonical codes — but
this is the reference's tool for visualizing a code and for demonstrating
the all-ones ("one-star") avoidance: the deepest all-1-bits leaf position
is taken over by the least frequent symbol and marked OneStar, whose
decoder consumes one extra (ignored) bit — the tree-shaped equivalent of
the spec path's `lengths[0] += 1` bump (symbol_counting.rs:85-90).

Construction (tree.rs:79-152): leaves sorted ascending by frequency
(stable), code lengths from the package-merge generator, then a
bottom-up layer merge — each level pairs queue nodes (right popped first,
so the tree grows to the right) and carries the merged parents up one
layer.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

from .package_merge import package_merge_lengths

LEAF = "leaf"
ONESTAR = "onestar"
INNER = "inner"


@dataclass
class Node:
    frequency: int
    index: int
    kind: str
    symbol: int | None = None       # LEAF / ONESTAR
    left: int | None = None         # INNER
    right: int | None = None        # INNER


class HuffmanTree:
    """Right-growing Huffman tree over (symbol, frequency) pairs."""

    def __init__(
        self, symbols_and_frequencies: list[tuple[int, int]], limit: int = 15
    ):
        pairs = sorted(symbols_and_frequencies, key=lambda p: p[1])
        lengths = package_merge_lengths([f for _, f in pairs], limit)
        self.nodes: list[Node] = [
            Node(frequency=f, index=i, kind=LEAF, symbol=s)
            for i, (s, f) in enumerate(pairs)
        ]
        self.leaf_count = len(self.nodes)
        self.least_frequent_symbol_node_index = 0

        max_depth = max(lengths, default=0)
        layers: list[list[int]] = [[] for _ in range(max_depth + 1)]
        for index, depth in enumerate(lengths):
            layers[depth].append(index)
        self._build_structure(layers)

    def _build_structure(self, layers: list[list[int]]) -> None:
        """Bottom-up queue merge (tree.rs:118-152): per layer, pair queue
        nodes right-first into parents; leftovers + parents carry up."""
        merging: deque[int] = deque()
        future: deque[int] = deque()
        for layer in reversed(layers):
            merging.extend(layer)
            while len(merging) > 1:
                right = self.nodes[merging.popleft()]
                left = self.nodes[merging.popleft()]
                node = Node(
                    frequency=left.frequency + right.frequency,
                    index=len(self.nodes),
                    kind=INNER,
                    left=left.index,
                    right=right.index,
                )
                self.nodes.append(node)
                future.append(node.index)
            merging.extend(future)
            future.clear()
        self.root_index = merging.popleft()

    # -- one-star replacement (tree.rs:28-58) ---------------------------

    def replace_onestar(self) -> None:
        """Swap the all-ones-path leaf with the least frequent symbol and
        mark the all-ones position OneStar (its codeword implicitly gains
        one ignored bit)."""
        self._replace(self.root_index, True)

    def _replace(self, current: int, only_ones_taken: bool) -> None:
        node = self.nodes[current]
        if node.kind == INNER:
            self._replace(node.left, False)
            self._replace(node.right, only_ones_taken)
        elif node.kind == LEAF and only_ones_taken:
            least = self.least_frequent_symbol_node_index
            a, b = self.nodes[current], self.nodes[least]
            # swap the two positions, keep index == position, mark OneStar
            self.nodes[current] = Node(
                frequency=b.frequency, index=current, kind=ONESTAR,
                symbol=b.symbol,
            )
            if least != current:
                self.nodes[least] = Node(
                    frequency=a.frequency, index=least, kind=LEAF,
                    symbol=a.symbol,
                )

    # -- debug decoder (tree.rs:155-204) --------------------------------

    def decode_sequence(self, data: bytes) -> list[int]:
        """MSB-first tree-walk decode; OneStar consumes one extra bit.
        Trailing bits that do not complete a codeword are dropped, exactly
        like the reference's byte-loop."""
        out: list[int] = []
        total_bits = 8 * len(data)
        pos = 0
        current = self.root_index
        while pos < total_bits:
            bit = (data[pos // 8] >> (7 - pos % 8)) & 1
            node = self.nodes[current]
            if node.kind != INNER:
                raise ValueError("single-symbol tree cannot be walked")
            current = node.right if bit else node.left
            node = self.nodes[current]
            if node.kind == LEAF:
                out.append(node.symbol)
                current = self.root_index
            elif node.kind == ONESTAR:
                out.append(node.symbol)
                pos += 1  # the star bit is skipped
                current = self.root_index
            pos += 1
        return out

    # -- ASCII display (tree.rs:207-284) --------------------------------

    def _box(self, index: int) -> list[str]:
        node = self.nodes[index]
        if node.kind == LEAF:
            return [f"(s:{node.symbol},f:{node.frequency})"]
        if node.kind == ONESTAR:
            return [" •", " ║", "╔╝", f"(s:{node.symbol},f:{node.frequency})"]
        left_box = self._box(node.left)
        right_box = self._box(node.right)
        lw = len(left_box[0])
        rw = len(right_box[0])
        result = [
            f"{' ' * lw}•{' ' * rw}",
            f"{' ' * lw}║{' ' * rw}",
        ]
        lpos = (
            _first_nonspace(left_box[0]) * 2 + len(left_box[0].strip())
        ) // 2
        rpos = (
            _first_nonspace(right_box[0]) * 2 + len(right_box[0].strip())
        ) // 2
        result.append(
            " " * lpos
            + "╔"
            + "═" * (lw - lpos - 1)
            + "╩"
            + "═" * rpos
            + "╗"
            + " " * (rw - rpos - 1)
        )
        for i in range(max(len(left_box), len(right_box))):
            lstr = left_box[i] if i < len(left_box) else " " * lw
            rstr = right_box[i] if i < len(right_box) else " " * rw
            result.append(f"{lstr} {rstr}")
        return result

    def __str__(self) -> str:
        return "\n".join(self._box(self.root_index)) + "\n"


def _first_nonspace(s: str) -> int:
    for i, c in enumerate(s):
        if c != " ":
            return i
    return 0
