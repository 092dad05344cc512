"""PyTorch port, the edge cases of the weighted histogram (csrc/histogram.cu)
and of the Arai plane DCT (csrc/plane_dct.cu), from
tests/torch_port_fixtures.py: their plain versions against the JAX
functions on the CPU, exactly (the outputs are integers). chip_smoke.py
holds the kernels against these plain versions on the same cases on the
card, each also from a view 4 bytes past a 16-byte boundary.

- histogram_grouped_plain, and the wrapper on CPU tensors, against
  dmmt_jpeg_encoder_tpu.ops.pallas_histogram.pallas_histogram_grouped on
  every case of HISTOGRAM_EDGE_CASES: its CPU path (an int32 scatter-add)
  on the cases whose symbols are in range, its Pallas kernel in interpret
  mode on the cases with symbols out of range, which the kernel counts
  nowhere where the CPU path wraps or clamps them (ROADMAP C2);
- pipeline.plane_dct_quant, and the wrapper on CPU tensors, against the
  JAX plane path jitted (pipeline._plane_dct_zigzag_blocks(..., "plane"))
  on every shape of PLANE_DCT_EDGE_SHAPES (saturated groups, DCs on x.5
  after / q, a table past 8 bits).

Apart from the other kernels' edge files, so that each stays under 40 s."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmmt_jpeg_encoder_tpu import pipeline as jpipe
from dmmt_jpeg_encoder_tpu.ops.pallas_histogram import pallas_histogram_grouped
from dmmt_jpeg_encoder_tpu_torch.ops.dct import arai_pass
from dmmt_jpeg_encoder_tpu_torch.ops.histogram import histogram_grouped, histogram_grouped_plain
from dmmt_jpeg_encoder_tpu_torch.ops.pallas_dct import plane_dct_quant
from dmmt_jpeg_encoder_tpu_torch.pipeline import plane_dct_quant as plane_dct_quant_plain
from dmmt_jpeg_encoder_tpu_torch.pipeline import plane_to_zigzag_blocks
from torch_port_fixtures import (
    HISTOGRAM_EDGE_CASES,
    PLANE_DCT_EDGE_SHAPES,
    histogram_edge_inputs,
    plane_mm_edge_inputs,
)

IN_RANGE = [c for c in HISTOGRAM_EDGE_CASES if c[3] != "out_of_range"]
OUT_OF_RANGE = [c for c in HISTOGRAM_EDGE_CASES if c[3] == "out_of_range"]

_jax_plane = jax.jit(lambda p, q: jpipe._plane_dct_zigzag_blocks(p, q, False, "plane"))


def _port_histograms(symbols: np.ndarray, weights: np.ndarray, n_bins: int):
    args = (torch.from_numpy(symbols), torch.from_numpy(weights), n_bins)
    return histogram_grouped_plain(*args), histogram_grouped(*args)


@pytest.mark.parametrize("case", IN_RANGE, ids=str)
def test_histogram_plain_matches_jax_on_in_range_cases(monkeypatch, case):
    monkeypatch.delenv("DMMT_PALLAS_INTERPRET", raising=False)
    g, m, n_bins, _ = case
    symbols, weights = histogram_edge_inputs(case)
    want = np.asarray(pallas_histogram_grouped(jnp.asarray(symbols), jnp.asarray(weights), n_bins))
    for got in _port_histograms(symbols, weights, n_bins):
        assert got.dtype == torch.int32 and got.shape == (g, n_bins)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", OUT_OF_RANGE, ids=str)
def test_histogram_plain_matches_pallas_kernel_on_out_of_range_cases(monkeypatch, case):
    monkeypatch.setenv("DMMT_PALLAS_INTERPRET", "1")
    g, m, n_bins, _ = case
    symbols, weights = histogram_edge_inputs(case)
    want = np.asarray(pallas_histogram_grouped(
        jnp.asarray(symbols), jnp.asarray(weights, jnp.float32), n_bins))
    for got in _port_histograms(symbols, weights, n_bins):
        assert got.dtype == torch.int32 and got.shape == (g, n_bins)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("content", ["in_range", "out_of_range", "past_2_24"])
def test_histogram_edge_cases_reach_unaligned_rows(content):
    """Some case of each content has rows whose bases are not 16-byte
    aligned (G > 1 with M % 4 != 0), and weights 0, 1, larger and negative
    where its content has them."""
    cases = [c for c in HISTOGRAM_EDGE_CASES if c[3] == content and c[0] > 1 and c[1] % 4]
    assert cases
    w = np.concatenate([histogram_edge_inputs(c)[1].reshape(-1) for c in cases])
    assert (w > 1).any() and (content == "past_2_24" or ((w == 0).any() and (w < 0).any()))


def test_histogram_edge_cases_pass_2_24():
    """The past_2_24 cases hold a bin whose count passes 2^24 and is not a
    float32 value, so a float32 count would round it."""
    for case in (c for c in HISTOGRAM_EDGE_CASES if c[3] == "past_2_24"):
        symbols, weights = histogram_edge_inputs(case)
        counts = histogram_grouped_plain(torch.from_numpy(symbols), torch.from_numpy(weights), case[2])
        top = int(counts.max())
        assert top > 2**24 and int(np.float32(top)) != top


@pytest.mark.parametrize("h,w", PLANE_DCT_EDGE_SHAPES)
def test_plane_dct_plain_matches_jax_on_edge_shapes(h, w):
    plane, q = plane_mm_edge_inputs(h, w)
    want = np.asarray(_jax_plane(jnp.asarray(plane), jnp.asarray(q)))
    args = (torch.from_numpy(plane), torch.from_numpy(q))
    for got in (plane_dct_quant_plain(*args), plane_dct_quant(*args)):
        assert got.dtype == torch.int16 and got.shape == (h, w)
        np.testing.assert_array_equal(plane_to_zigzag_blocks(got, False).numpy(), want)


def test_plane_dct_edge_inputs_put_arai_dcs_on_half_boundaries():
    """The flat odd groups' Arai DC / q lands within float32 rounding of
    x.5, so the rounding's direction rests on the passes' exact bits."""
    plane, q = plane_mm_edge_inputs(24, 1928)
    x = torch.from_numpy(plane)
    rows = arai_pass(x.reshape(24, 241, 8), dim=-1).reshape(3, 8, 241, 8)
    dc = arai_pass(rows, dim=1)[:, 0, :, 0] / float(q[0])
    frac = (dc.abs() - dc.abs().floor()).reshape(-1)[3::5]
    assert len(frac) > 100 and bool(((frac - 0.5).abs() < 1e-3).all())
