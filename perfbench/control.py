"""The control of the benchmark's correctness check, on the card.

    python3 perfbench/control.py --workload NAME --seeds 11,12,13 [--seconds 3]

Runs the cell as perfbench/run.py does, at its own size and load, with the
program replaced by the plain reference computed in bfloat16, the next
precision below the float32 that the configurations' byte contract rests
on (perfbench/reference/phase1.py). The check has to find it wrong: each
seed prints its result line, and the command exits 1 unless every seed
came out not correct. The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import harness, reference  # noqa: E402


def lower_precision(cell: harness.Cell, device: str):
    """The program hook: every request's frames encoded by the reference in
    bfloat16."""
    def hook(_call):
        return lambda frames: [reference.encode(f, cell.maxval, cell.config, device=device,
                                                precision="bfloat16") for f in frames]
    return hook


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--rehearse", action="store_true", help="on the CPU at a tiny size (tests)")
    args = ap.parse_args(argv)
    cell = harness.Cell.load(args.workload)
    device = "cpu" if args.rehearse else "cuda"
    caught = True
    for seed in (int(s) for s in args.seeds.split(",")):
        result = harness.run_cell(cell, seed, args.seconds, False, time.monotonic(), args.rehearse,
                                  lower_precision(cell, device))
        caught &= not result["correct"]
        print(json.dumps({"seed": seed, **result}), flush=True)
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())
