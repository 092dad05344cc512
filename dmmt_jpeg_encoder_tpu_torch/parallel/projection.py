"""Projected multi-card scaling model, from floors measured on one H100.

Counterpart of dmmt_jpeg_encoder_tpu.parallel.projection: the same model
and names, none of its TPU data. An n-card encode runs the one-dispatch
encode on a 1/n MCU-row share of each image per card; the slab
(onedispatch.start_one_dispatch_slab, parallel/sharding.py's sharded slab)
row-stacks B same-geometry images per program, so a program's fixed costs
are paid once per B images:

    T_per_image(n, B) = T_program(B * rows / n) / B + COLLECTIVE_MS

with T_program read from MEASURED single-card program floors by
piecewise-linear interpolation (no parametric fit), and the B-image slab
programs from their own measured grid. Every T_program input is a
single-card floor, so the whole model is fed from one card; the one
cross-card term is COLLECTIVE_MS.

Efficiency(n, B) = T_per_image(1, 1) / (n * T_per_image(n, B)).

The measured points below are floors of this port on an NVIDIA H100 (the
bench's _floor_single and _floor_slab: BDEV starts or 2 slab starts in
flight, one read of the last total_bits, median of 11 rounds; 3840 wide,
P420, Specification tables, the default modes), all taken in ONE process
so that the ratios are not polluted by the host's swing between processes
(PERF.md). Command:

    python -m dmmt_jpeg_encoder_tpu_torch.tools.projection_grid --rounds 11

The projection is of one card's numbers: how the cards' copies and streams
overlap across several cards is not measured (PERF.md section 7).
"""

from __future__ import annotations

from ..config import EncoderConfig
from ..encoder import _use_one_dispatch, slab_gate
from .sharding import onedispatch_allowed

# (rows, ms) single-image one-dispatch program floors, 3840 wide, each
# program one CUDA graph replay (onedispatch.py): NVIDIA H100 80GB HBM3,
# 700.00 W, 2026-10-17, tools.projection_grid --rounds 11 (one process
# with MEASURED_T_SLAB_MS).
MEASURED_T_MS: tuple[tuple[int, float], ...] = (
    (272, 1.1226726250015417),
    (544, 1.14639162499941),
    (1088, 1.1782509999989088),
    (2176, 1.2793114999993804),
    (4320, 1.4598717500007297),
)

# (slab_b, rows_per_image) -> ms per PROGRAM of a B-image row-stacked slab
# (the default per-image-pack arm): the JAX grid's keys, and whole 4K
# frames (2160 rows) at depths up to the port's gate (encoder.SLAB_B), all
# within onedispatch.slab_max_blocks(): NVIDIA H100 80GB HBM3, 700.00 W,
# 2026-10-17, tools.projection_grid --rounds 11 (same process as above).
MEASURED_T_SLAB_MS: dict[tuple[int, int], float] = {
    (2, 272): 1.226593000012599,
    (4, 272): 1.3717715000041153,
    (8, 272): 1.5971010000157548,
    (12, 272): 1.7566815000122915,
    (16, 272): 1.975552999994079,
    (32, 272): 2.777033499995696,
    (48, 272): 3.6334225000018705,
    (64, 272): 4.413849999991726,
    (2, 544): 1.2670115000048554,
    (4, 544): 1.4132819999872481,
    (8, 544): 1.72591000000466,
    (16, 544): 2.336650500012638,
    (32, 544): 3.4681820000059815,
    (2, 1088): 1.3454999999851225,
    (4, 1088): 1.677317999991601,
    (8, 1088): 2.1431400000153644,
    (16, 1088): 3.1704090000062024,
    (17, 1088): 3.253312499992944,
    (2, 2160): 1.5140120000012303,
    (4, 2160): 2.0274175000167816,
    (8, 2160): 2.850399000010384,
    (16, 2160): 4.575102000018205,
}

# Per-extra-image overhead inside one slab program (ms/image beyond
# T(B*rows)), used ONLY for (B, rows) points absent from the grid; derived
# as the JAX comment derives it, from the B=8 x 272 slab against the
# equal-height single image: (T_slab(8, 272) - T(2176)) / 7.
SLAB_OVERHEAD_MS_PER_IMAGE = 0.0453985000023392

# What the sharded encode moves between its shards at n = 2 (the DC
# hand-off, the histograms to the first shard and their sum, the tables
# back): bench._collective_ms, same-card copies (one card; a cross-card
# figure needs a machine with several cards), NVIDIA H100 80GB HBM3,
# 700.00 W, 2026-10-17, tools.projection_grid --rounds 11.
COLLECTIVE_MS = 0.017174623192334038


def t_program_ms(rows: int) -> float:
    """Measured one-dispatch program time for a `rows`-row image
    (piecewise-linear between measured points; extrapolates the edge
    segments' slopes outside the measured range)."""
    pts = MEASURED_T_MS
    if rows <= pts[0][0]:
        (r0, t0), (r1, t1) = pts[0], pts[1]
    elif rows >= pts[-1][0]:
        (r0, t0), (r1, t1) = pts[-2], pts[-1]
    else:
        for (r0, t0), (r1, t1) in zip(pts, pts[1:]):
            if r0 <= rows <= r1:
                break
    return t0 + (t1 - t0) * (rows - r0) / (r1 - r0)


def t_slab_program_ms(slab_b: int, rows_per_image: int) -> float:
    """Program time for a slab_b-image row-stacked slab program.

    Prefers the MEASURED 2-D grid point (exact (B, rows) match, then
    B-interpolation between measured B values at the same rows); falls
    back to the single-image curve at the stacked height plus the
    measured per-extra-image overhead."""
    if slab_b == 1:
        return t_program_ms(rows_per_image)
    exact = MEASURED_T_SLAB_MS.get((slab_b, rows_per_image))
    if exact is not None:
        return exact
    same_rows = sorted(
        (b, ms) for (b, r), ms in MEASURED_T_SLAB_MS.items() if r == rows_per_image
    )
    if len(same_rows) >= 2:
        bs = [b for b, _ in same_rows]
        if bs[0] <= slab_b <= bs[-1]:
            for (b0, m0), (b1, m1) in zip(same_rows, same_rows[1:]):
                if b0 <= slab_b <= b1:
                    return m0 + (m1 - m0) * (slab_b - b0) / (b1 - b0)
        # extrapolate the marginal per-image cost of the last segment
        (b0, m0), (b1, m1) = same_rows[-2], same_rows[-1]
        return m1 + (m1 - m0) / (b1 - b0) * (slab_b - b1)
    return t_program_ms(slab_b * rows_per_image) + SLAB_OVERHEAD_MS_PER_IMAGE * (slab_b - 1)


def projected_time_per_image_ms(rows: int, n_chips: int, slab_b: int = 1) -> float:
    """Projected per-image program time with the image's rows split over
    n_chips and slab_b same-geometry images row-stacked per shard program.
    Shard heights are MCU-aligned (16-row multiples for P420), as the
    sharded encode runs them (272, not 270, for 4K over 8 cards)."""
    mcu_rows = -(-rows // 16)
    rows_per_shard = -(-mcu_rows // n_chips) * 16
    per_image = t_slab_program_ms(slab_b, rows_per_shard) / slab_b
    if n_chips > 1:
        per_image += COLLECTIVE_MS
    return per_image


def best_slab_b(rows: int, n_chips: int, max_b: int = 64, width: int = 3840) -> int:
    """The slab depth encode_batch's gate (encoder.slab_depth) gives max_b
    same-geometry P420 images of rows x width over n_chips devices that run
    the kernels: 1 where the image takes no one-dispatch encode (the
    device table build's bound, DMMT_NO_ONEDISPATCH on one card,
    DMMT_NO_FUSED_PACK on several), else encoder.slab_gate, which reads the
    same knobs as the gate (DMMT_SLAB, DMMT_SLAB_B, DMMT_SLAB_MAX_ROWS,
    DMMT_SLAB_MAX_BLOCKS through onedispatch.slab_max_blocks). The JAX
    function copied that package's TPU caps; the port's gate has none of
    them."""
    config = EncoderConfig(num_shards=n_chips)
    if max_b < 2:
        return 1
    if n_chips > 1:
        allowed = onedispatch_allowed(config, rows, width)
    else:
        allowed = _use_one_dispatch(config, rows, width)
    if not allowed:
        return 1
    return slab_gate(rows, width, config.chroma_subsampling, n_chips, max_b)


def projected_scaling_table(
    rows: int = 2160,
    width: int = 3840,
    slab_b: int | None = 1,
    chips: tuple = (1, 2, 4, 8),
) -> list[dict]:
    """One row per mesh size: projected per-image ms, Mpix/s, and
    efficiency vs n * single-card-single-image. slab_b=None picks the
    encode_batch gate's B per mesh size (best_slab_b)."""
    t1 = projected_time_per_image_ms(rows, 1, 1)
    out = []
    for n in chips:
        b = best_slab_b(rows, n, width=width) if slab_b is None else slab_b
        t = projected_time_per_image_ms(rows, n, b)
        out.append(
            {
                "chips": n,
                "slab_b": b,
                "proj_ms_per_image": round(t, 2),
                "proj_mpix_per_s": round(rows * width / 1e6 * 1e3 / t, 1),
                "proj_efficiency": round(t1 / (n * t), 3),
            }
        )
    return out
