"""PyTorch port, the stuffing kernel (csrc/scan_stuff.cu) on the card. It
has no CPU form, so this test skips without a card; on a card:
`python -m pytest --noconftest tests/test_torch_scan_stuff_card.py`. It
imports no JAX, and holds the kernel against its plain version
(bitstream/scan_stuff.stuff_scan_plain) and the host's stuffing
(device_pack.finalize_scan_bytes), which tests/test_torch_kernel_edges.py
holds against the JAX package on the CPU:

- every STUFF_EDGE_CASES case, each row alone and the rows as one slab:
  the same lengths, and every byte before the kernel's state region equal
  to the plain version's (the stream kept, the stuffed copy, zeros
  between);
- a stream of ~1,500 chunks (6 MB, 1% 0xFF), as a 21600x21600 tile's
  scan takes thousands;
- the 4K golden through encode_array, and a program instance replayed
  after a frame with a longer scan: the tail it finds is zeroed again (no
  byte of the first frame's stuffed copy is left past the second's) and
  its bytes equal the CPU's."""

import hashlib

import numpy as np
import pytest
import torch

import dmmt_jpeg_encoder_tpu_torch as dt
from dmmt_jpeg_encoder_tpu_torch import onedispatch as tod
from dmmt_jpeg_encoder_tpu_torch.bitstream.device_pack import finalize_scan_bytes
from dmmt_jpeg_encoder_tpu_torch.bitstream.scan_stuff import (
    stuff_scan,
    stuff_scan_plain,
    stuffed_start,
    tail_layout,
)
from dmmt_jpeg_encoder_tpu_torch.tables import quantization_table_pair
from torch_port_fixtures import (
    FIXTURES,
    STUFF_EDGE_CASES,
    fixture_pixels,
    load_goldens,
    stuff_edge_rows,
)


def _kernel_against_plain(words: np.ndarray, bits: np.ndarray) -> None:
    """stuff_scan on the card against the plain version on the CPU, for
    int32 [B, n_words] rows: lengths, and each row's bytes before the state
    region; each stuffed copy against the host's stuffing."""
    card = torch.from_numpy(words).cuda()
    host = torch.from_numpy(words.copy())
    one = len(bits) == 1
    got = stuff_scan(card[0] if one else card, torch.from_numpy(bits).cuda()).tolist()
    want = stuff_scan_plain(host[0] if one else host, torch.from_numpy(bits)).tolist()
    torch.cuda.synchronize()
    assert got == want
    _, state_off = tail_layout(4 * words.shape[1])
    for r, (length, nbits) in enumerate(zip(got, bits.tolist())):
        raw = card[r].view(torch.uint8)[:state_off].cpu().numpy()
        np.testing.assert_array_equal(raw, host[r].view(torch.uint8)[:state_off].numpy())
        if length >= 0:
            start = stuffed_start(nbits)
            assert raw[start : start + length].tobytes() == finalize_scan_bytes(words[r], nbits)


def test_stuffing_kernel_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the stuffing kernel has no CPU form")
    for case in STUFF_EDGE_CASES:
        words, bits = stuff_edge_rows(case)
        for r in range(len(bits)):
            _kernel_against_plain(words[r : r + 1], bits[r : r + 1])
        _kernel_against_plain(words, bits)

    rng = np.random.default_rng(4100)
    n_bytes = 6 << 20
    raw = rng.integers(0, 255, n_bytes).astype(np.uint8)
    raw[rng.random(n_bytes) < 0.01] = 0xFF
    words = np.zeros((1, 3 * n_bytes // 4 + 64), np.int32)
    words[0].view(np.uint8)[:n_bytes] = raw
    words[0].view(np.uint8)[n_bytes - 1] &= 0xE0  # the 5 bits past the stream
    _kernel_against_plain(words, np.array([8 * n_bytes - 5], np.int64))

    f = FIXTURES["4k_p420"]
    cfg = dt.EncoderConfig(chroma_subsampling=dt.ChromaSubsamplingPreset(f["preset"]),
                           quality=f["quality"])
    jpeg = dt.encode_array(fixture_pixels("4k_p420"), f["maxval"], cfg, device="cuda")
    assert hashlib.sha256(jpeg).hexdigest() == load_goldens()["4k_p420"]["jpeg_sha256"]

    lq, cq = quantization_table_pair(cfg.quantization_preset, cfg.quality)
    noisy = rng.integers(0, 256, (240, 320, 3), dtype=np.uint8)
    smooth = np.ascontiguousarray(fixture_pixels("333x1001_p422")[:240, :320])
    first = tod.start_one_dispatch(noisy, 255, cfg, lq, cq, device="cuda")
    first_end = stuffed_start(int(first.total_bits)) + int(first.stuffed)
    tod.finish_one_dispatch(first)  # gives the instance back
    second = tod.start_one_dispatch(smooth, 255, cfg, lq, cq, device="cuda")
    assert second.words.data_ptr() == first.words.data_ptr()  # the same instance replayed
    torch.cuda.synchronize()
    nbits, length = int(second.total_bits), int(second.stuffed)
    start = stuffed_start(nbits)
    assert 0 <= start + length < first_end
    _, state_off = tail_layout(4 * second.words.numel())
    tail = second.words.view(torch.uint8).cpu().numpy()
    assert not tail[(nbits + 7) // 8 : start].any() and not tail[start + length : state_off].any()
    want = tod.finish_one_dispatch(tod.start_one_dispatch(smooth, 255, cfg, lq, cq, device="cpu"))
    assert tod.finish_one_dispatch(second) == want
