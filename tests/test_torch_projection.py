"""The port's scaling projection (dmmt_jpeg_encoder_tpu_torch/parallel/
projection.py) against the JAX package's.

Both modules' measured points are monkeypatched to one shared grid, so
the same model must give the same floats: the cases of
test_projection.py (exact point, B interpolation and extrapolation, the
fallback, MCU-aligned shard rows, the scaling table) and a sweep of
geometries. best_slab_b differs on purpose: the port's reads its own
gate, so it is held against encoder.slab_depth under the gate's knobs.
Last, the committed H100 points: shapes and keys, and no value of the
JAX module's TPU data."""

import numpy as np
import pytest

from dmmt_jpeg_encoder_tpu.parallel import projection as jax_pj
from dmmt_jpeg_encoder_tpu_torch.config import EncoderConfig
from dmmt_jpeg_encoder_tpu_torch.encoder import slab_depth
from dmmt_jpeg_encoder_tpu_torch.onedispatch import blocks_per_image, slab_max_blocks
from dmmt_jpeg_encoder_tpu_torch.parallel import projection as pj
from dmmt_jpeg_encoder_tpu_torch.parallel import sharding
from dmmt_jpeg_encoder_tpu_torch.utils import capability

SHARED_T_MS = ((272, 3.1), (544, 3.6), (1088, 4.4), (2176, 6.2), (4320, 9.7))
SHARED_SLAB_MS = {(2, 272): 6.0, (4, 272): 9.0, (8, 272): 16.0, (4, 544): 12.0,
                  (16, 544): 30.5, (2, 1088): 8.25}


@pytest.fixture()
def grid(monkeypatch):
    for mod in (pj, jax_pj):
        monkeypatch.setattr(mod, "MEASURED_T_MS", SHARED_T_MS)
        monkeypatch.setattr(mod, "MEASURED_T_SLAB_MS", dict(SHARED_SLAB_MS))
        monkeypatch.setattr(mod, "SLAB_OVERHEAD_MS_PER_IMAGE", 0.5)
        monkeypatch.setattr(mod, "COLLECTIVE_MS", 0.013)
    return pj


def test_exact_grid_point_preferred(grid):
    assert grid.t_slab_program_ms(4, 272) == jax_pj.t_slab_program_ms(4, 272) == 9.0


def test_b_interpolation_between_measured(grid):
    assert grid.t_slab_program_ms(3, 272) == jax_pj.t_slab_program_ms(3, 272) == 7.5


def test_b_extrapolation_uses_last_marginal_cost(grid):
    assert grid.t_slab_program_ms(10, 272) == jax_pj.t_slab_program_ms(10, 272) == \
        16.0 + (16.0 - 9.0) / 4 * 2


def test_fallback_uses_single_curve_plus_overhead(grid):
    want = grid.t_program_ms(2 * 2176) + 0.5
    assert grid.t_slab_program_ms(2, 2176) == jax_pj.t_slab_program_ms(2, 2176) == want


def test_single_image_is_the_1d_curve(grid):
    assert grid.t_slab_program_ms(1, 2176) == grid.t_program_ms(2176) == \
        jax_pj.t_slab_program_ms(1, 2176)


def test_shard_rows_mcu_aligned(grid):
    # 4K over 8 cards runs 272-row shards (17 MCU rows), not 270
    t8 = grid.projected_time_per_image_ms(2160, 8, 1)
    assert t8 == grid.t_program_ms(272) + grid.COLLECTIVE_MS == \
        jax_pj.projected_time_per_image_ms(2160, 8, 1)


@pytest.mark.parametrize("rows", [1, 100, 272, 300, 544, 1000, 1088, 2160, 2176, 4000, 4320, 9000])
def test_t_program_ms_equals_jax(grid, rows):
    assert grid.t_program_ms(rows) == jax_pj.t_program_ms(rows)


@pytest.mark.parametrize("rows", [272, 1080, 2160, 4320])
def test_projected_time_equals_jax(grid, rows):
    for n in (1, 2, 3, 4, 8):
        for b in (1, 2, 3, 4, 8, 16, 17):
            assert grid.projected_time_per_image_ms(rows, n, b) == \
                jax_pj.projected_time_per_image_ms(rows, n, b), (rows, n, b)


@pytest.mark.parametrize("slab_b", [1, 4, 16])
def test_scaling_table_equals_jax(grid, slab_b):
    for rows, width in ((2160, 3840), (1080, 1920), (4320, 7680)):
        assert grid.projected_scaling_table(rows, width, slab_b) == \
            jax_pj.projected_scaling_table(rows, width, slab_b)


def test_scaling_table_reads_the_gate(grid):
    rows = grid.projected_scaling_table(slab_b=None)
    assert [r["chips"] for r in rows] == [1, 2, 4, 8]
    assert [r["slab_b"] for r in rows] == [grid.best_slab_b(2160, n) for n in (1, 2, 4, 8)]
    assert rows[0]["proj_ms_per_image"] == round(grid.projected_time_per_image_ms(2160, 1, rows[0]["slab_b"]), 2)


def _frames(rows: int, width: int, n: int) -> list:
    return [np.broadcast_to(np.zeros(1, np.uint8), (rows, width, 3))] * n


# environment of the gate's knobs -> (name, value) pairs
GATE_ENVS = {
    "defaults": {},
    "max_rows_1088": {"DMMT_SLAB_MAX_ROWS": "1088"},
    "max_rows_256": {"DMMT_SLAB_MAX_ROWS": "256"},
    "slab_b_4": {"DMMT_SLAB_B": "4"},
    "slab_b_64": {"DMMT_SLAB_B": "64"},
    "max_blocks_100000": {"DMMT_SLAB_MAX_BLOCKS": "100000"},
    "max_blocks_50000_b_64": {"DMMT_SLAB_MAX_BLOCKS": "50000", "DMMT_SLAB_B": "64"},
    "slab_off": {"DMMT_SLAB": "0"},
    "no_onedispatch": {"DMMT_NO_ONEDISPATCH": "1"},
    "no_fused_pack": {"DMMT_NO_FUSED_PACK": "1"},
}


@pytest.mark.parametrize("env", list(GATE_ENVS))
def test_best_slab_b_equals_the_gate(monkeypatch, env):
    """best_slab_b is encoder.slab_depth's depth for max_b images, on one
    card and over n shards of devices that run the kernels."""
    for k, v in GATE_ENVS[env].items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(capability, "kernels_capable", lambda device: True)
    for rows, width in ((272, 3840), (1080, 1920), (2160, 3840), (4320, 7680), (33, 47)):
        for n in (1, 2, 4, 8):
            cfg = EncoderConfig(num_shards=n)
            devices = None if n == 1 else sharding.shard_devices("cpu", n)
            for max_b in (1, 2, 3, 16, 64):
                want = slab_depth(_frames(rows, width, max_b), cfg, devices)
                assert pj.best_slab_b(rows, n, max_b, width) == want, (rows, width, n, max_b)


def test_best_slab_b_carries_no_tpu_caps():
    # the JAX gate capped 4K-over-2 at 1088-row slices and rounded to
    # powers of two; the port's gate takes depth SLAB_B at every height
    from dmmt_jpeg_encoder_tpu_torch.encoder import SLAB_B

    assert pj.best_slab_b(2160, 1) == SLAB_B
    assert pj.best_slab_b(4320, 2) == SLAB_B
    assert pj.best_slab_b(2160, 8, max_b=12) == 12


def test_committed_points_are_h100_measurements():
    rows = [r for r, _ in pj.MEASURED_T_MS]
    assert rows == sorted(rows) == [272, 544, 1088, 2176, 4320]
    assert all(ms > 0 for _, ms in pj.MEASURED_T_MS)
    assert set(jax_pj.MEASURED_T_SLAB_MS) <= set(pj.MEASURED_T_SLAB_MS)
    for (b, r), ms in pj.MEASURED_T_SLAB_MS.items():
        assert ms > 0 and b * blocks_per_image(r, 3840, EncoderConfig().chroma_subsampling) \
            <= slab_max_blocks()
    # the B=8 x 272 slab against the equal-height single image, as the JAX
    # module derives its constant
    assert pj.SLAB_OVERHEAD_MS_PER_IMAGE == pytest.approx(
        (pj.MEASURED_T_SLAB_MS[(8, 272)] - dict(pj.MEASURED_T_MS)[2176]) / 7, rel=1e-12)
    assert 0 < pj.COLLECTIVE_MS != jax_pj.COLLECTIVE_MS
    # no value of the JAX module's TPU data
    jax_values = {ms for _, ms in jax_pj.MEASURED_T_MS} | set(jax_pj.MEASURED_T_SLAB_MS.values())
    port_values = {ms for _, ms in pj.MEASURED_T_MS} | set(pj.MEASURED_T_SLAB_MS.values())
    assert not jax_values & port_values
    assert pj.SLAB_OVERHEAD_MS_PER_IMAGE != jax_pj.SLAB_OVERHEAD_MS_PER_IMAGE
