"""PyTorch port, the edge cases of the matmul plane DCT (csrc/mxu_dct.cu)
and of the emission pack (csrc/emission_pack.cu), from
tests/torch_port_fixtures.py: their plain versions against the JAX
functions on the CPU, exactly (the outputs are integers). chip_smoke.py
holds the kernels against these plain versions on the same cases on the
card, each also from a view 4 bytes past a 16-byte boundary.

- mxu_dct_reference, and the wrapper on CPU tensors, against the jitted
  dmmt_jpeg_encoder_tpu.ops.mxu_dct.mxu_dct_reference on every shape of
  PLANE_MM_EDGE_SHAPES (saturated groups, DCs on x.5 after / q, the
  largest AC);
- pack_to_words, and the wrapper on CPU tensors, against the jitted
  dmmt_jpeg_encoder_tpu.bitstream.device_pack.pack_to_words on every case
  of EMISSION_PACK_EDGE_CASES (N around the kernel's tile, 2040-bit blocks,
  masked blocks, images at word-aligned bases, a short word buffer). The
  JAX function takes no boff: it is given block bits whose exclusive scan
  is boff (each image's last block also spans the gap to the next base),
  which places every emission at the same bit.

Apart from the other kernels' edge files, so that each stays under 40 s."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmmt_jpeg_encoder_tpu.bitstream import device_pack as jpack
from dmmt_jpeg_encoder_tpu.ops import mxu_dct as jmxu
from dmmt_jpeg_encoder_tpu_torch.bitstream.device_pack import pack_to_words
from dmmt_jpeg_encoder_tpu_torch.bitstream.emission_pack import pack_emission_words
from dmmt_jpeg_encoder_tpu_torch.ops.dct import matmul_dct_pass
from dmmt_jpeg_encoder_tpu_torch.ops.mxu_dct import mxu_dct_reference, plane_dct_quant_mxu
from torch_port_fixtures import (
    EMISSION_PACK_EDGE_CASES,
    PLANE_MM_EDGE_SHAPES,
    emission_pack_edge_inputs,
    emission_pack_tile_arms,
    plane_mm_edge_inputs,
)

_jax_mm = jax.jit(jmxu.mxu_dct_reference)
_jax_pack = jax.jit(jpack.pack_to_words, static_argnums=4)


@pytest.mark.parametrize("h,w", PLANE_MM_EDGE_SHAPES)
def test_plane_mm_plain_matches_jax_on_edge_shapes(h, w):
    plane, q = plane_mm_edge_inputs(h, w)
    want = np.asarray(_jax_mm(jnp.asarray(plane), jnp.asarray(q)))
    args = (torch.from_numpy(plane), torch.from_numpy(q))
    for got in (mxu_dct_reference(*args), plane_dct_quant_mxu(*args)):
        assert got.dtype == torch.int16 and got.shape == (h, w)
        np.testing.assert_array_equal(got.numpy(), want)


def test_plane_mm_edge_inputs_put_dcs_on_half_boundaries():
    """The flat odd groups' DC / q lands within float32 rounding of x.5, so
    the rounding's direction rests on the contractions' exact order."""
    plane, q = plane_mm_edge_inputs(24, 1928)
    x = torch.from_numpy(plane).reshape(3, 8, 241, 8)
    dc = matmul_dct_pass(matmul_dct_pass(x, 1), 3)[:, 0, :, 0] / float(q[0])
    frac = (dc.abs() - dc.abs().floor()).reshape(-1)[3::5]
    assert len(frac) > 100 and bool(((frac - 0.5).abs() < 1e-3).all())


def _jax_words(values, lens, offs, bits, n_words, boff):
    if boff is not None:
        bits = np.append(np.diff(boff), bits[-1]).astype(np.int32)
    words, total = _jax_pack(*(jnp.asarray(x) for x in (values, lens, offs, bits)), n_words)
    return np.asarray(words), int(total)


@pytest.mark.parametrize("case", EMISSION_PACK_EDGE_CASES, ids=str)
def test_emission_pack_plain_matches_jax_on_edge_cases(case):
    values, lens, offs, bits, n_words, boff = emission_pack_edge_inputs(case)
    want, want_total = _jax_words(values, lens, offs, bits, n_words, boff)
    args = [torch.from_numpy(x) for x in (values, lens, offs, bits)]
    tb = None if boff is None else torch.from_numpy(boff)
    for words, total in (pack_to_words(*args, n_words, tb), pack_emission_words(*args, n_words, boff=tb)):
        assert words.dtype == torch.int32 and words.shape == (n_words,)
        assert int(total) == want_total
        np.testing.assert_array_equal(words.numpy().view(np.uint32), want)


@pytest.mark.parametrize("arm", ["empty", "shared", "over-full"])
def test_emission_pack_edge_cases_reach_every_tile_arm(arm):
    """Some case has a tile that takes each arm of the kernel: no bit, its
    words in the shared window, past the window."""
    cases = [c for c in EMISSION_PACK_EDGE_CASES
             if arm in emission_pack_tile_arms(*(emission_pack_edge_inputs(c)[i] for i in (3, 5)))]
    assert cases


def test_emission_pack_short_cases_drop_words():
    for case in EMISSION_PACK_EDGE_CASES:
        _, _, _, bits, n_words, boff = emission_pack_edge_inputs(case)
        end = int(bits.astype(np.int64).sum()) if boff is None else int(boff[-1]) + int(bits[-1])
        assert ((end + 31) // 32 > n_words) == case[3]
