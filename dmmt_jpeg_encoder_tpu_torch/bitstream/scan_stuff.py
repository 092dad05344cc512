"""Byte stuffing on the device, behind the scan pack: the packed words ->
the scan's final bytes, in the tail of the same word buffer.

The scan-pack kernels (bitstream/fused_pack.py) write a stream of uint32
words in memory byte order into a buffer sized for the worst case (64
words a block + 2) and zeroed on every call; a photograph's stream fills
about 1% of it. `stuff_scan` 1-pads the stream's last byte and stuffs a
0x00 after every 0xFF (device_pack.finalize_scan_bytes, the host's pass,
does the same) into that buffer's tail, so a finish fetches the final
bytes and only copies them: one launch of the kernel csrc/scan_stuff.cu,
which reads the stream's length on the device, so a captured program
replays it with no host value. Per row of the buffer (tail_layout):

    [0, n_bytes)              the packed stream
    [start, start + length)   the stuffed stream (stuffed_start)
    [state_off, row end)      int64: the kernel's chunk states and counter,
                              and last the stuffed length

The length reads -1 where the tail is too short for the stuffed stream
(a stream of some 16 bits a pixel): the host then stuffs the packed words
itself (finalize_scan_bytes). `stuff_scan_plain` is the kernel's plain
version, which a CPU tensor runs.
"""

from __future__ import annotations

import torch

from ..kernels import build

CHUNK = 4096  # stream bytes a chunk of csrc/scan_stuff.cu
_ALIGN = 16   # the stuffed stream starts at the next multiple of this


def tail_layout(row_bytes: int) -> tuple[int, int]:
    """(chunk states, the state region's byte offset) of a row of
    row_bytes bytes, as the kernel lays them out: the region holds those
    states, the chunk counter and the stuffed length, and ends the row."""
    n_cap = -(-(row_bytes // 2) // CHUNK)
    return n_cap, row_bytes - 8 * (n_cap + 2)


def stuffed_start(total_bits: int) -> int:
    """Where a stream of total_bits bits has its stuffed copy: the byte
    after the stream, rounded up to 16."""
    n_bytes = (int(total_bits) + 7) // 8
    return -(-n_bytes // _ALIGN) * _ALIGN


def stuffed_lengths(words: torch.Tensor) -> torch.Tensor:
    """The stuffed length of each row of a word buffer (int64 [B] for
    [B, n_words], [1] for [n_words]): a view of the last 8 bytes of each
    row."""
    return words.view(torch.int64)[..., -1:].reshape(-1)


def _rows(words: torch.Tensor, total_bits: torch.Tensor) -> tuple[torch.Tensor, int]:
    """words as [B, n_words] rows and the row length in bytes, checked."""
    rows = words.reshape(-1, words.shape[-1])
    if words.dtype != torch.int32 or words.ndim not in (1, 2):
        raise ValueError(f"expected int32 [n_words] or [B, n_words] words, got {words.dtype} "
                         f"{tuple(words.shape)}")
    if not rows.is_contiguous() or rows.shape[1] % 2:
        raise ValueError("expected contiguous rows of an even number of words")
    if tuple(total_bits.shape) != (rows.shape[0],):
        raise ValueError(f"expected [{rows.shape[0]}] total_bits, got {tuple(total_bits.shape)}")
    row_bytes = 4 * int(rows.shape[1])
    if tail_layout(row_bytes)[1] < 0:
        raise ValueError(f"a row of {row_bytes} bytes cannot hold the stuffing state")
    return rows, row_bytes


def stuff_scan(words: torch.Tensor, total_bits: torch.Tensor) -> torch.Tensor:
    """Stuff each row's stream into its tail: words int32 [n_words] or
    [B, n_words] (memory-order stream words, zero past total_bits, n_words
    even and at least 2 past the stream's words, as a scan pack's worst-case
    buffer is) and total_bits int64 [B] ([1] for one row) on one device ->
    the stuffed lengths, int64 [B], a view into the rows (stuffed_lengths;
    -1 where the tail is too short). A CPU tensor runs the plain version; a
    CUDA tensor launches the kernel or raises."""
    if words.device.type == "cpu":
        return stuff_scan_plain(words, total_bits)
    rows, row_bytes = _rows(words, total_bits)
    if words.device.type != "cuda":
        raise ValueError(f"stuffing kernel needs a CUDA tensor, got {words.device}")
    if total_bits.device != words.device or total_bits.dtype != torch.int64:
        raise ValueError("expected int64 total_bits on the words' device")
    lib = build.load()
    err = lib.dmmt_scan_stuff(rows.data_ptr(), int(rows.shape[0]), row_bytes,
                              total_bits.contiguous().data_ptr(),
                              torch.cuda.current_stream(words.device).cuda_stream)
    build.check(err, "dmmt_scan_stuff")
    build.LAUNCHES["scan_stuff"] += 1
    return stuffed_lengths(words)


def stuff_scan_plain(words: torch.Tensor, total_bits: torch.Tensor) -> torch.Tensor:
    """The stuffing kernel's plain version, same contract (stuff_scan): the
    stuffed stream and its length written into each row's tail, the
    lengths returned as a view. The kernel's chunk states stay zero."""
    rows, row_bytes = _rows(words, total_bits)
    _, state_off = tail_layout(row_bytes)
    lengths = stuffed_lengths(words)
    for row, bits in zip(rows, total_bits.tolist()):
        raw = row.view(torch.uint8)
        n_bytes, start = (bits + 7) // 8, stuffed_start(bits)
        length = -1
        if start + n_bytes <= state_off:
            data = raw[:n_bytes].clone()
            pad = n_bytes * 8 - bits
            if pad:
                data[-1] |= (1 << pad) - 1
            ff = data == 0xFF
            n_ff = int(ff.sum())
            if start + n_bytes + n_ff <= state_off:
                pos = start + torch.arange(n_bytes) + torch.cumsum(ff, 0) - ff.to(torch.int64)
                raw[pos] = data
                raw[pos[ff] + 1] = 0
                length = n_bytes + n_ff
        row.view(torch.int64)[-1] = length
    return lengths
