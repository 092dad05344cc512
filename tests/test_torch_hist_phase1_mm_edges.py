"""PyTorch port, the edge cases of the block-histogram kernel
(csrc/block_hist.cu) and of the fused matmul phase 1 (csrc/fused_phase1.cu),
from tests/torch_port_fixtures.py: their plain versions against the JAX
functions on the CPU, exactly (the outputs are integers). chip_smoke.py
holds the kernels against these plain versions on the same cases on the
card, each also from a view 4 bytes past a 16-byte boundary.

- block_histograms_plain, and the wrapper on CPU tensors (one segment, or
  Cb and Cr as two), against the jitted
  dmmt_jpeg_encoder_tpu.entropy.categorize.symbol_histograms on the first
  n_valid blocks of the concatenation (a prefix mask), for every case of
  BLOCK_HIST_EDGE_CASES; symbol_histograms of the port on a pair of
  segments under each DMMT_HIST mode;
- fused_phase1_reference, and the wrapper on CPU tensors, against the
  jitted JAX fused_phase1_reference (which takes the planes padded to the
  MCU multiple) on every geometry of PHASE1_EDGE_CASES.

Apart from tests/test_torch_kernel_edges.py, which holds the other
kernels' edge cases, so that each file stays under 40 s."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmmt_jpeg_encoder_tpu.config import QuantizationTablePreset
from dmmt_jpeg_encoder_tpu.entropy import categorize as jcat
from dmmt_jpeg_encoder_tpu.ops import fused_phase1 as jfused1
from dmmt_jpeg_encoder_tpu.tables import quantization_table_pair
from dmmt_jpeg_encoder_tpu_torch.config import ChromaSubsamplingPreset
from dmmt_jpeg_encoder_tpu_torch.entropy import categorize as tcat
from dmmt_jpeg_encoder_tpu_torch.ops.block_hist import block_histograms_plain, fused_block_histograms
from dmmt_jpeg_encoder_tpu_torch.ops.fused_phase1 import fused_phase1, fused_phase1_reference
from dmmt_jpeg_encoder_tpu_torch.ops.geometry import padded_size
from torch_port_fixtures import (
    BLOCK_HIST_EDGE_CASES,
    PHASE1_EDGE_CASES,
    block_hist_edge_segments,
    phase1_edge_pixels,
)

_jax_histograms = jax.jit(jcat.symbol_histograms)


def _want_histograms(segments, n_valid):
    whole = np.concatenate(segments)
    mask = np.arange(len(whole)) < (len(whole) if n_valid is None else n_valid)
    return [np.asarray(h) for h in _jax_histograms(jnp.asarray(whole), jnp.asarray(mask))]


@pytest.mark.parametrize("case", BLOCK_HIST_EDGE_CASES, ids=str)
def test_block_hist_plain_matches_jax_on_edge_cases(case):
    segments = block_hist_edge_segments(case)
    n_valid = case[2]
    want = _want_histograms(segments, n_valid)
    whole = torch.from_numpy(np.concatenate(segments))
    k = len(whole) if n_valid is None else n_valid
    tensors = tuple(torch.from_numpy(s) for s in segments)
    wrapper_in = tensors if len(tensors) > 1 else tensors[0]
    for got in (block_histograms_plain(whole[:k]), fused_block_histograms(wrapper_in, n_valid)):
        for g, w in zip(got, want):
            assert g.dtype == torch.int32 and g.shape == w.shape
            np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("mode", ["fused", "pallas", "matmul"])
def test_symbol_histograms_of_two_segments_match_jax(monkeypatch, mode):
    """The chroma call's pair (Cb, Cr) counts as the concatenation under
    every DMMT_HIST mode: two segments for the block histogram, a
    concatenation for the weighted one."""
    monkeypatch.setenv("DMMT_HIST", mode)
    case = ("random", (129, 127), None)
    segments = block_hist_edge_segments(case)
    want = _want_histograms(segments, None)
    got = tcat.symbol_histograms(tuple(torch.from_numpy(s) for s in segments))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_block_hist_wrapper_refuses_bad_segments():
    b = torch.zeros((4, 64), dtype=torch.int16)
    with pytest.raises(ValueError):
        fused_block_histograms((b, b), 9)
    with pytest.raises(ValueError):
        fused_block_histograms((b, b, b))
    with pytest.raises(ValueError):
        fused_block_histograms((b, b.to("meta")))


@pytest.mark.parametrize("h,w,preset,maxval", PHASE1_EDGE_CASES)
def test_fused_phase1_plain_matches_jax_on_edge_geometries(h, w, preset, maxval):
    p = ChromaSubsamplingPreset(preset)
    hr, vr = p.horizontal_rate, p.vertical_rate
    px = phase1_edge_pixels(h, w, maxval)
    ph, pw = padded_size(h, w, p)
    planes = [jnp.pad(jnp.asarray(px[..., i]), ((0, ph - h), (0, pw - w))) for i in range(3)]
    lq, cq = quantization_table_pair(QuantizationTablePreset.SPECIFICATION)
    want = jax.jit(lambda r, g, b, m, l, c: jfused1.fused_phase1_reference(r, g, b, m, l, c, hr, vr))(
        *planes, jnp.float32(maxval), jnp.asarray(lq), jnp.asarray(cq))
    args = (torch.from_numpy(px), maxval, torch.from_numpy(lq), torch.from_numpy(cq), p)
    for got in (fused_phase1_reference(*args), fused_phase1(*args)):
        for a, b in zip(got, want):
            assert a.dtype == torch.int16
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
