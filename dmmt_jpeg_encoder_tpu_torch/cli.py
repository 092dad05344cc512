"""Command-line interface of the PyTorch/CUDA port.

Flag for flag the JAX package's CLI (dmmt_jpeg_encoder_tpu/cli.py, itself
a mirror of the reference's src/cli.rs:75-115):

    python -m dmmt_jpeg_encoder_tpu_torch INPUT_FILE OUTPUT_FILE
        [-b/--bits_per_channel {8,16,32}]        default 8
        [-p/--chroma_subsampling_preset {P444,P422,P420}]  default P420
        [-t/--threads N]                         default os.cpu_count()
        [-q/--quantization_table PRESET]         default Specification
        [--quality Q] [--dct ...] [--shards N] [--no-native]
        [--scan-backend ...] [--one-dispatch ...]

plus `--device` (default cuda), which lets the CPU tests drive the CLI
with the kernels' plain versions. `--one-dispatch off` and `--scan-backend
host` take the two-dispatch encode, and `--no-native` its Python host
packer, `--dct` selects the DCT variant and `--shards N` splits the image
over N devices, as in the JAX CLI. With `--shards`, `--device` may list
one device per shard, comma-separated (`cuda:0,cuda:0` puts two shards on
one card); a single CUDA device means N consecutive cards. An encode that
cannot run (too few cards, a DMMT_P1_PREC other than high or highest)
exits with code 1.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

from .config import (
    ChromaSubsamplingPreset,
    DCTVariant,
    EncoderConfig,
    QuantizationTablePreset,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dmmt-jpeg-encoder-tpu-torch",
        description=(
            "Baseline JPEG encoder on an NVIDIA GPU: P3 PPM -> JFIF/JPEG "
            "(PyTorch + hand-written CUDA kernels)."
        ),
    )
    p.add_argument("input_file", help="path to the P3 (ASCII) PPM input image")
    p.add_argument("output_file", help="path for the JPEG output")
    p.add_argument(
        "-b", "--bits_per_channel", type=int, choices=(8, 16, 32), default=8,
        help="SOF0 sample precision field (default: 8)",
    )
    p.add_argument(
        "-p", "--chroma_subsampling_preset",
        choices=[e.value for e in ChromaSubsamplingPreset],
        default=ChromaSubsamplingPreset.P420.value,
        help="chroma subsampling (default: P420)",
    )
    p.add_argument(
        "-t", "--threads", type=int, default=os.cpu_count() or 1,
        help="host worker threads for the PPM parser (reference pool-size "
        "semantics, cli.rs:178-180)",
    )
    p.add_argument(
        "-q", "--quantization_table",
        default=QuantizationTablePreset.SPECIFICATION.value,
        help=(
            "quantization table preset: "
            + ", ".join(e.value for e in QuantizationTablePreset)
            + " (aliases: Spec, Default, 0-8; default: Specification)"
        ),
    )
    p.add_argument(
        "--quality", type=int, default=None,
        help="IJG quality 1..100 scaling the quantization preset "
        "(default: use the preset's raw tables)",
    )
    p.add_argument(
        "--dct", choices=[e.value for e in DCTVariant], default=DCTVariant.ARAI.value,
        help="DCT implementation (default: arai)",
    )
    p.add_argument(
        "--shards", type=int, default=1,
        help="number of devices to split the image over (default: 1)",
    )
    p.add_argument(
        "--no-native", action="store_true",
        help="use the pure-Python scan packer instead of the C fast path "
        "(with --scan-backend host)",
    )
    p.add_argument(
        "--scan-backend", choices=("auto", "device", "host"), default="auto",
        help="entropy-scan assembly: on-device packing, host packing, or auto "
        "(= device; default: auto)",
    )
    p.add_argument(
        "--one-dispatch", choices=("auto", "off"), default="auto",
        help="build Huffman tables on the device and pack in the same "
        "enqueue (default: auto; off: host tables, two dispatches)",
    )
    p.add_argument(
        "--device", default="cuda",
        help="torch device to encode on (default: cuda); with --shards, a "
        "comma-separated list of one device per shard",
    )
    return p


def parse_args(argv: list[str] | None = None) -> tuple[argparse.Namespace, EncoderConfig]:
    parser = build_parser()
    args = parser.parse_args(argv)
    try:
        config = EncoderConfig(
            chroma_subsampling=ChromaSubsamplingPreset(args.chroma_subsampling_preset),
            quantization_preset=QuantizationTablePreset.parse(args.quantization_table),
            bits_per_channel=args.bits_per_channel,
            dct_variant=DCTVariant(args.dct),
            num_shards=args.shards,
            quality=args.quality,
            scan_backend=args.scan_backend,
            one_dispatch=args.one_dispatch,
        )
    except ValueError as e:
        parser.error(str(e))
    return args, config


def main(argv: list[str] | None = None) -> int:
    args, config = parse_args(argv)
    from .encoder import encode_ppm_image
    from .io.ppm import read_ppm

    device = args.device.split(",") if "," in args.device else args.device
    try:
        image = read_ppm(args.input_file, threads=args.threads)
    except OSError as e:
        print(f"error: cannot read '{args.input_file}': {e}", file=sys.stderr)
        return 1
    except Exception as e:
        print(f"error: invalid PPM input: {e}", file=sys.stderr)
        return 1
    try:
        jpeg = encode_ppm_image(image, config, use_native=not args.no_native, device=device)
        Path(args.output_file).write_bytes(jpeg)
    except ValueError as e:  # DMMT_P1_PREC neither high nor highest, too few cards
        print(f"error: {e}", file=sys.stderr)
        return 1
    except OSError as e:
        print(f"error: cannot write '{args.output_file}': {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
