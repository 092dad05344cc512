"""PyTorch port, the edge shapes of the tilings of the block DCT kernel
(csrc/block_dct.cu) and the table lookup kernel (csrc/table_lookup.cu),
from tests/torch_port_fixtures.py: their plain versions against the JAX
functions on the CPU, exactly (the outputs are integers). chip_smoke.py
holds the kernels against these plain versions on the same shapes on the
card.

- The block DCT's plain version (one sequential fma chain per output)
  against the jitted dmmt_jpeg_encoder_tpu.ops.fused.fused_reference, for
  N of one block, a tile less one, a tile, a tile and one, three tiles and
  five.
- The grouped lookup's plain version against pallas_table_lookup_grouped
  for every (G, m, T) of LOOKUP_EDGE_SHAPES, with symbols in range: the
  JAX CPU fallback clamps the others (ROADMAP C2). With -1, T and T + 1
  among the symbols, against the kernels' contract in numpy: 0 outside
  [0, T), the group's entry inside."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmmt_jpeg_encoder_tpu.ops import fused as jfused
from dmmt_jpeg_encoder_tpu.ops.pallas_lookup import pallas_table_lookup_grouped
from dmmt_jpeg_encoder_tpu_torch.ops.fused import fused_dct_quantize_zigzag, fused_matrix, fused_reference
from dmmt_jpeg_encoder_tpu_torch.ops.lookup import table_lookup_grouped
from torch_port_fixtures import (
    BLOCK_DCT_EDGE_N,
    LOOKUP_EDGE_SHAPES,
    block_dct_edge_inputs,
    lookup_edge_inputs,
)

_jax_fused_reference = jax.jit(jfused.fused_reference)


@pytest.mark.parametrize("n", BLOCK_DCT_EDGE_N)
def test_block_dct_plain_matches_jax_on_edge_shapes(n):
    blocks, q = block_dct_edge_inputs(n)
    want = np.asarray(_jax_fused_reference(jnp.asarray(blocks), jnp.asarray(q)))
    got = fused_dct_quantize_zigzag(torch.from_numpy(blocks), q)
    assert got.dtype == torch.int16 and tuple(got.shape) == (n, 64)
    np.testing.assert_array_equal(got.numpy(), want)
    direct = fused_reference(torch.from_numpy(blocks), torch.from_numpy(fused_matrix(q)))
    np.testing.assert_array_equal(direct.numpy(), want)


@pytest.mark.parametrize("g,m,t", LOOKUP_EDGE_SHAPES)
def test_lookup_plain_matches_jax_on_edge_shapes(g, m, t):
    sym, tables = lookup_edge_inputs(g, m, t, in_range=True)
    want = np.asarray(pallas_table_lookup_grouped(jnp.asarray(sym), jnp.asarray(tables)))
    got = table_lookup_grouped(torch.from_numpy(sym), torch.from_numpy(tables.astype(np.int32)))
    assert got.dtype == torch.int32 and tuple(got.shape) == (g, m)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))

    sym, tables = lookup_edge_inputs(g, m, t, in_range=False)
    inside = (sym >= 0) & (sym < t)
    assert not inside.all()
    entries = np.take_along_axis(tables.astype(np.int32), np.where(inside, sym, 0), axis=1)
    got = table_lookup_grouped(torch.from_numpy(sym), torch.from_numpy(tables.astype(np.int32)))
    np.testing.assert_array_equal(got.numpy(), np.where(inside, entries, 0))
