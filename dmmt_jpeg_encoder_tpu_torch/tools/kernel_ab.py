"""The block DCT and table lookup kernels of this checkout against another
build of the same C entry points, on one card, in one process.

    python -m dmmt_jpeg_encoder_tpu_torch.tools.kernel_ab OTHER_CSRC [--rounds N]

OTHER_CSRC is a csrc/ directory, for example the parent commit's unpacked
with git archive. Its block_dct.cu and table_lookup.cu (with the headers
beside them) are compiled with this checkout's nvcc flags into a library
of their own under build/kernels/. The inputs are those the paths give the
two kernels, captured from encodes of the fixtures of
tests/torch_port_fixtures.py: the FUSED variant's luma, Cb and Cr blocks of
the 3840x2160 P420 frame (three calls), the staged pack's two lookups of
that frame (DMMT_NO_FUSED_PACK=1, one_dispatch="off"), and the fused
batch's two grouped lookups of the 16 x 1080p batch (fused_batch=16).
Both builds are held against the plain versions on every input, exactly.
Rounds run in the order other, this, this, other; every time is
tools/timing.device_ms of one call list, beside the library call that
computes the same function (torch.matmul by M, torch.gather). Prints one
JSON line per (input, build, round), one summary line with the medians
(also of each call of a list alone) and the SM clock and power draw that
nvidia-smi reads while this checkout's call list runs back to back for a
second, and the float32 rate of one 8192^3 torch.matmul (cuBLAS, TF32
off) as a yardstick of what the card's FFMA pipes reach; then the card's
name and power limit. Needs a card and nvcc.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from ..kernels import build
from .timing import device_ms

REPO = Path(__file__).resolve().parents[2]
SOURCES = ("block_dct.cu", "table_lookup.cu")
ENTRY_POINTS = ("dmmt_block_dct_zz", "dmmt_table_lookup_grouped")


def build_other(csrc: Path) -> ctypes.CDLL:
    """Compile and load the two kernels of another csrc/ directory."""
    srcs = [csrc / s for s in SOURCES]
    h = hashlib.sha256(" ".join(build.NVCC_FLAGS).encode())
    for s in srcs + sorted(csrc.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    out = build.BUILD_DIR / f"kernel_ab_{h.hexdigest()[:16]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        objs = [out.with_name(f"{out.stem}.{s.stem}.o") for s in srcs]
        procs = [subprocess.Popen(build.compile_command(s, o), stderr=subprocess.PIPE, text=True)
                 for s, o in zip(srcs, objs)]
        for s, p in zip(srcs, procs):
            _, err = p.communicate()
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {s}:\n{err}")
        subprocess.run(build.link_command(objs, out), check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    for name in ENTRY_POINTS:
        fn = getattr(lib, name)
        fn.argtypes = list(build._SIGNATURES[name])
        fn.restype = ctypes.c_int
    return lib


@contextlib.contextmanager
def _patched(module, name: str, wrap):
    real = getattr(module, name)
    setattr(module, name, wrap(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def capture_inputs(dev: torch.device) -> dict:
    """{input name: (kind, [(a, b, out) of each call])}: the block DCT's
    blocks and M, the lookup's symbols and tables, as the encodes pass
    them, and the kernel's output in the encode."""
    import dmmt_jpeg_encoder_tpu_torch as port
    from ..bitstream import device_pack
    from ..ops import fused
    from torch_port_fixtures import BATCH_FIXTURES, batch_frames, fixture_pixels

    calls: list = []

    def grab_dct(real):
        def wrapped(blocks, qtable):
            out = real(blocks, qtable)
            m = torch.from_numpy(fused.fused_matrix(qtable)).to(blocks.device).contiguous()
            calls.append((blocks.clone(memory_format=torch.contiguous_format), m, out.clone()))
            return out
        return wrapped

    def grab_lookup(real):
        def wrapped(symbols, tables):
            out = real(symbols, tables)
            calls.append((symbols.to(torch.int32).clone(memory_format=torch.contiguous_format),
                          tables.to(torch.int32).clone(memory_format=torch.contiguous_format), out.clone()))
            return out
        return wrapped

    px = fixture_pixels("4k_p420")
    cfg = port.EncoderConfig(chroma_subsampling=port.ChromaSubsamplingPreset.P420)
    fb = BATCH_FIXTURES["batch_1080p_p420"]
    inputs = {}
    with _patched(fused, "fused_dct_quantize_zigzag", grab_dct):
        port.encode_array(px, 255, dataclasses.replace(cfg, dct_variant=port.DCTVariant.FUSED), device=dev)
    inputs["block_dct_zz 4k_p420 FUSED (luma, Cb, Cr)"] = ("dct", calls[:])
    calls.clear()
    os.environ["DMMT_NO_FUSED_PACK"] = "1"
    try:
        with _patched(device_pack, "table_lookup_grouped", grab_lookup):
            port.encode_array(px, 255, dataclasses.replace(cfg, one_dispatch="off"), device=dev)
            inputs["table_lookup 4k_p420 staged pack (DC, AC)"] = ("lookup", calls[:])
            calls.clear()
            port.encode_batch(batch_frames("batch_1080p_p420"), fb["maxval"], cfg,
                              fused_batch=fb["n"], device=dev)
            inputs[f"table_lookup batch_1080p_p420 fused_batch={fb['n']} (DC, AC)"] = ("lookup", calls[:])
    finally:
        os.environ.pop("DMMT_NO_FUSED_PACK")
    torch.cuda.synchronize()
    return inputs


def runner(lib, kind: str, args: list):
    """(the call list on `lib`, one closure per call, their outputs): one C
    call per captured call."""
    outs = [torch.empty((a.shape[0], 64) if kind == "dct" else a.shape,
                        dtype=torch.int16 if kind == "dct" else torch.int32, device=a.device)
            for a, *_ in args]

    def one(k: int) -> None:
        (a, b, _), o = args[k], outs[k]
        stream = torch.cuda.current_stream().cuda_stream
        if kind == "dct":
            err = lib.dmmt_block_dct_zz(a.data_ptr(), int(a.shape[0]), b.data_ptr(), o.data_ptr(), stream)
        else:
            err = lib.dmmt_table_lookup_grouped(a.data_ptr(), b.data_ptr(), int(a.shape[0]),
                                                int(a.shape[1]), int(b.shape[1]), o.data_ptr(), stream)
        build.check(err, ENTRY_POINTS[kind != "dct"])

    def run() -> None:
        for k in range(len(args)):
            one(k)

    return run, [lambda k=k: one(k) for k in range(len(args))], outs


def plain(kind: str, args: list) -> list:
    from ..ops.fused import fused_reference
    from ..ops.lookup import table_lookup_grouped_plain

    return [fused_reference(a, b) if kind == "dct" else table_lookup_grouped_plain(a, b)
            for a, b, _ in args]


def library(kind: str, args: list):
    """One PyTorch call per captured call computing the same function
    (torch.matmul by M without the rounding, TF32 off; torch.gather)."""
    if kind == "dct":
        flat = [(a.reshape(-1, 64), b) for a, b, _ in args]
        return lambda: [torch.matmul(a, b) for a, b in flat]
    gathers = [(b, a.to(torch.int64)) for a, b, _ in args]
    return lambda: [torch.gather(t, 1, s) for t, s in gathers]


def report_mismatch(what: str, got: torch.Tensor, want: torch.Tensor, x: torch.Tensor) -> None:
    """Where and by how much an output differs from the plain version's."""
    diff = (got.to(torch.int64) - want.to(torch.int64)).reshape(got.shape[0], -1)
    rows = diff.ne(0).any(dim=1).nonzero()[:, 0]
    first = int(rows[0])
    print(json.dumps({"mismatch": what, "rows": int(rows.numel()), "of": int(got.shape[0]),
                      "values": int(diff.ne(0).sum()), "max_abs": int(diff.abs().max()),
                      "first_row": first, "got": got.reshape(got.shape[0], -1)[first].tolist(),
                      "want": want.reshape(want.shape[0], -1)[first].tolist(),
                      "input_finite": bool(torch.isfinite(x.to(torch.float32)).all())}), flush=True)


def clock_under_load(fn, seconds: float = 1.0) -> dict:
    """Median SM clock (MHz) and power draw (W) that nvidia-smi reads every
    100 ms while fn runs back to back for about `seconds`."""
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, text=True)
    try:
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=10)
    rows = [[float(v) for v in line.split(",")] for line in out.strip().splitlines() if line.strip()]
    return {"sm_clock_mhz": statistics.median(r[0] for r in rows),
            "power_w": statistics.median(r[1] for r in rows), "samples": len(rows)}


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other_csrc", type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO / "tests"))
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    libs = {"other": build_other(args.other_csrc.resolve()), "this": build.load()}
    order = ["other", "this", "this", "other"] * args.rounds
    times: dict = {}
    bad: list[str] = []
    under_load: dict = {}
    inputs = capture_inputs(dev)
    for name, (kind, calls) in inputs.items():
        want = plain(kind, calls)
        refs = {"plain": want, "the encode's kernel": [c[2] for c in calls]}
        runs, singles = {}, {}
        for label, lib in libs.items():
            run, singles[label], outs = runner(lib, kind, calls)
            run()
            torch.cuda.synchronize()
            refs[f"the {label} build"] = outs
            runs[label] = run
        for label, outs in refs.items():
            for k, (o, w) in enumerate(zip(outs, want)):
                if not torch.equal(o, w):
                    bad.append(f"{name} call {k}: {label} != plain")
                    report_mismatch(bad[-1], o, w, calls[k][0])
        for i, label in enumerate(order):
            ms = device_ms(runs[label])
            times.setdefault(name, {}).setdefault(label, []).append(ms)
            print(json.dumps({"input": name, "build": label, "round": i, "ms": ms}), flush=True)
        times[name]["library"] = [device_ms(library(kind, calls))]
        under_load[name] = clock_under_load(runs["this"])
        for label, fns in singles.items():
            for k, fn in enumerate(fns):
                ms = device_ms(fn)
                times[name].setdefault(f"{label}, call {k} alone", []).append(ms)
    # the card's float32 rate as cuBLAS reaches it: one 8192^3 product, TF32 off
    a = torch.randn(8192, 8192, device=dev)
    sgemm_tflops = 2 * 8192 ** 3 / device_ms(lambda: torch.matmul(a, a)) / 1e9
    del a
    print(json.dumps({"median_ms": {n: {k: statistics.median(v) for k, v in t.items()}
                                    for n, t in times.items()},
                      "this build under load": under_load,
                      "sgemm_8192_tflops": sgemm_tflops,
                      "shapes": {n: [list(a.shape) for a, *_ in c] for n, (_, c) in inputs.items()},
                      "device": torch.cuda.get_device_name(0)}))
    print(gpu_line())
    if bad:
        print("\n".join(bad), file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
