"""Measure the points of parallel/projection.py on a card.

    python -m dmmt_jpeg_encoder_tpu_torch.tools.projection_grid [--rounds 5] [--out FILE]

In one process, as the model needs: the single-image program floors
(bench._floor_single) of the 4k_p420 generator's frames 3840 wide at
SINGLE_ROWS rows; the slab program floors (bench._floor_slab) at the
(B, rows) keys of SLAB_KEYS, each slab built as the bench's slab stage
builds it (the 4K frame rolled down by 13 rows per image); the 2176-row
floor again at the end, to show the drift over the run; and the cost of
what the sharded encode moves between its shards at n = 2
(bench._collective_ms, same-card copies on one card). Every floor's JPEGs
are held against encode_array's two-dispatch encode of the same frames.
Each floor is the median of --rounds rounds, in ms per PROGRAM (a slab's
per-image time times B). Prints the card's "name, power.limit", one JSON
object with every point and SLAB_OVERHEAD_MS_PER_IMAGE derived as the
JAX module derives it, (T_slab(8, 272) - T(2176)) / 7, and writes the JSON
object to --out. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

from .. import bench

SINGLE_ROWS = (272, 544, 1088, 2176, 4320)
# the JAX grid's (B, rows) keys (its MEASURED_T_SLAB_MS), and whole 4K
# frames at depths up to the port's gate (encoder.SLAB_B: its slab takes
# every height, so one card slabs 4K frames), all within
# onedispatch.slab_max_blocks() at 3840 wide
SLAB_KEYS = ((2, 272), (4, 272), (8, 272), (12, 272), (16, 272), (32, 272), (48, 272), (64, 272),
             (2, 544), (4, 544), (8, 544), (16, 544), (32, 544),
             (2, 1088), (4, 1088), (8, 1088), (16, 1088), (17, 1088),
             (2, 2160), (4, 2160), (8, 2160), (16, 2160))
WIDTH = 3840


def _run(rows: int, rounds: int, device: str) -> bench._Bench:
    """A bench run object for the generator's rows x WIDTH frame."""
    args = argparse.Namespace(height=rows, width=WIDTH, preset="P420", seed=0, device=device,
                              rounds=rounds)
    return bench._Bench(args)


def single_floor_ms(rows: int, rounds: int, device: str) -> tuple[float, list[float]]:
    """(median, every round) ms of the rows-high frame's program floor,
    its JPEG held against the two-dispatch encode."""
    run = _run(rows, rounds, device)
    samples, jpeg = bench._floor_single(run.dev_px, run.config, run.luma_q, run.chroma_q, rounds)
    run.check(f"single {rows} rows", [jpeg], ["frame"])
    ms = [s * 1e3 for s in samples]
    return statistics.median(ms), ms


def main(argv: list[str] | None = None) -> int:
    import torch

    ap = argparse.ArgumentParser(prog="python -m dmmt_jpeg_encoder_tpu_torch.tools.projection_grid")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--out", type=Path, default=None, help="also write the JSON object here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("projection_grid: no CUDA device available", file=sys.stderr)
        return 1
    card = bench._card_label("cuda")
    print(card, flush=True)
    t_start = time.perf_counter()
    single, spread = {}, {}
    for rows in SINGLE_ROWS:
        single[rows], spread[f"single {rows}"] = single_floor_ms(rows, args.rounds, "cuda")
        print(f"single {rows} rows: {single[rows]:.4f} ms", flush=True)
    run = _run(2160, args.rounds, "cuda")
    slab = {}
    for b, rows in SLAB_KEYS:
        dev_stack, frames = run.slab_stack(b, rows)
        samples, jpegs = bench._floor_slab(dev_stack, run.config, run.luma_q, run.chroma_q,
                                           args.rounds)
        run.check(f"slab B={b}x{rows}", jpegs, frames)
        ms = [s * b * 1e3 for s in samples]
        slab[(b, rows)], spread[f"slab {b}x{rows}"] = statistics.median(ms), ms
        print(f"slab B={b} x {rows} rows: {slab[(b, rows)]:.4f} ms per program", flush=True)
    drift_ms, spread["single 2176 again"] = single_floor_ms(2176, args.rounds, "cuda")
    parts, jpeg = bench._collective_ms(run.pixels, run.config, ["cuda:0", "cuda:0"])
    run.check("sharded n=2", [jpeg], ["frame"])
    out = {
        "card": card,
        "torch": torch.__version__,
        "rounds": args.rounds,
        "width": WIDTH,
        "measured_t_ms": [[rows, single[rows]] for rows in SINGLE_ROWS],
        "measured_t_slab_ms": [[b, rows, ms] for (b, rows), ms in slab.items()],
        "single_2176_at_end_ms": drift_ms,
        "slab_overhead_ms_per_image": (slab[(8, 272)] - single[2176]) / 7,
        "collective_ms_n2_same_card": parts,
        "rounds_ms": spread,
        "seconds": time.perf_counter() - t_start,
    }
    text = json.dumps(out)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
