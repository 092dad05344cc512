"""Encoder configuration: chroma subsampling and quantization-table presets.

Carried over unchanged from dmmt_jpeg_encoder_tpu.config (the JAX
reference package), so both packages take the same configuration. The
reference encoder's two config enums:
- `ChromaSubsamplingPreset` (reference: src/image/subsampling.rs:11-55)
- `QuantizationTablePreset` (reference: src/image/writer/jpeg/quantization_tables.rs:232-326)

Presets are plain frozen dataclasses / enums; `config_from_jax` carries a
JAX-package config across by enum value without importing that package.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class SubsamplingMethod(enum.Enum):
    """How chroma is reduced (reference: src/image/subsampling.rs:57-60)."""

    SKIP = "skip"        # take the top-left sample of each h x v cell
    AVERAGE = "average"  # mean of the h x v cell


class ChromaSubsamplingPreset(enum.Enum):
    """4:4:4 / 4:2:2 / 4:2:0 presets (reference: src/image/subsampling.rs:11-55).

    P444 -> rates (1,1) + Skip; P422 -> (2,1) + Average; P420 -> (2,2) + Average.
    """

    P444 = "P444"
    P422 = "P422"
    P420 = "P420"

    @property
    def horizontal_rate(self) -> int:
        return {"P444": 1, "P422": 2, "P420": 2}[self.value]

    @property
    def vertical_rate(self) -> int:
        return {"P444": 1, "P422": 1, "P420": 2}[self.value]

    @property
    def method(self) -> SubsamplingMethod:
        return (
            SubsamplingMethod.SKIP
            if self is ChromaSubsamplingPreset.P444
            else SubsamplingMethod.AVERAGE
        )

    @property
    def luma_blocks_per_mcu(self) -> int:
        """Number of luma blocks interleaved per MCU in the scan
        (reference: src/...encoder/block_fold_iterator.rs:96-148)."""
        return self.horizontal_rate * self.vertical_rate

    @property
    def mcu_width(self) -> int:
        """MCU pixel width = horizontal_rate * 8 (pad multiple,
        reference: src/...jpeg/transformer.rs:48-51)."""
        return self.horizontal_rate * 8

    @property
    def mcu_height(self) -> int:
        return self.vertical_rate * 8


class QuantizationTablePreset(enum.Enum):
    """Compiled-in quantization table presets
    (reference: src/image/writer/jpeg/quantization_tables.rs:232-326).

    CLI aliases mirror the reference's clap aliases
    (quantization_tables.rs:258-284).
    """

    SPECIFICATION = "Specification"
    FLAT = "Flat"
    MSSIM_KODAK_TUNED = "MSSIM-Kodak-Tuned"
    PSNR_HVS_N_KODAK_TUNED = "PSNR-HVS-N-Kodak-Tuned"
    DCTUNE_PERCEPTUAL_OPTIMIZATION = "DCTune-Perceptual-Optimization"
    A_VISUAL_DETECTION_MODEL = "A-visual-detection-model"
    AN_IMPROVED_DETECTION_MODEL = "An-improved-detection-model"

    @classmethod
    def aliases(cls) -> dict[str, "QuantizationTablePreset"]:
        m: dict[str, QuantizationTablePreset] = {}
        for p in cls:
            m[p.value.lower()] = p
        m.update(
            {
                "spec": cls.SPECIFICATION,
                "default": cls.SPECIFICATION,
                "0": cls.SPECIFICATION,
                "1": cls.FLAT,
                "2": cls.MSSIM_KODAK_TUNED,
                "4": cls.PSNR_HVS_N_KODAK_TUNED,
                "6": cls.DCTUNE_PERCEPTUAL_OPTIMIZATION,
                "7": cls.A_VISUAL_DETECTION_MODEL,
                "8": cls.AN_IMPROVED_DETECTION_MODEL,
            }
        )
        return m

    @classmethod
    def parse(cls, text: str) -> "QuantizationTablePreset":
        key = text.strip().lower()
        table = cls.aliases()
        if key not in table:
            raise ValueError(
                f"Unknown quantization table preset '{text}'. "
                f"Choices: {[p.value for p in cls]} (aliases: Spec, Default, 0-8)"
            )
        return table[key]


class DCTVariant(enum.Enum):
    """Which 8x8 DCT implementation to run on device.

    The reference ships three interchangeable DCT impls selected in code
    (src/cosine_transform/{simple,separated,arai}.rs); we expose them as a
    runtime knob. ARAI is the production path (transformer.rs:141).
    """

    SIMPLE = "simple"        # textbook O(n^4), verification only
    SEPARATED = "separated"  # C @ X @ C^T two-matmul form
    ARAI = "arai"            # vectorized AAN butterflies (production)
    FUSED = "fused"          # Pallas fused DCT+quantize+zigzag kernel


@dataclass(frozen=True)
class EncoderConfig:
    """Everything the encode pipeline needs besides the pixels.

    Mirrors `JpegTransformationOptions` (reference: src/image/writer/jpeg.rs:25-39)
    plus the JAX package's device knobs. The port encodes every config the
    JAX package does: every DCT variant, shards, scan backend and dispatch
    mode. The one-dispatch start functions raise NotImplementedError for
    an image past the device table build's bound (encoder.py sends it down
    the two-dispatch path), and so does the multi-process encode
    (parallel/multihost.py) outside the one-dispatch sharded encode.
    """

    chroma_subsampling: ChromaSubsamplingPreset = ChromaSubsamplingPreset.P420
    quantization_preset: QuantizationTablePreset = QuantizationTablePreset.SPECIFICATION
    bits_per_channel: int = 8
    dct_variant: DCTVariant = DCTVariant.ARAI
    # Number of mesh shards for multi-chip encode (1 = single chip).
    num_shards: int = 1
    # Entropy-scan assembly: "device" packs the bitstream on the device
    # (bitstream/device_pack.py, ~64x smaller device->host transfer), "host"
    # re-encodes coefficients with the native-C/Python packer; "auto" is
    # "device" (encoder._resolve_backend).
    scan_backend: str = "auto"
    # IJG quality (1..100) scaling applied to the quantization preset, or
    # None for the preset's raw tables (the reference has fixed presets
    # only; this extension enables standard quality sweeps).
    quality: int | None = None
    # One-dispatch encode: Huffman tables built ON DEVICE and the scan
    # packed in the same program as the pipeline (onedispatch.py; one CUDA
    # graph on a card) with no mid-encode host sync. "auto" uses it
    # whenever the device packer is active and the image is within the
    # device table build's exactness bound; "off" forces the two-dispatch
    # host-table path (two programs on a card).
    one_dispatch: str = "auto"

    def __post_init__(self) -> None:
        if self.bits_per_channel not in (8, 16, 32):
            raise ValueError("bits_per_channel must be one of 8, 16, 32")
        if self.quality is not None and not 1 <= self.quality <= 100:
            raise ValueError("quality must be in 1..100")
        if self.scan_backend not in ("auto", "device", "host"):
            raise ValueError(
                f"scan_backend must be 'auto', 'device', or 'host' "
                f"(got {self.scan_backend!r})"
            )
        if self.one_dispatch not in ("auto", "off"):
            raise ValueError(
                f"one_dispatch must be 'auto' or 'off' "
                f"(got {self.one_dispatch!r})"
            )


def config_from_jax(cfg) -> EncoderConfig:
    """The port's EncoderConfig equal to a dmmt_jpeg_encoder_tpu
    EncoderConfig (or any object with the same fields). Enums are matched by
    value, so this module never imports the JAX package."""
    return EncoderConfig(
        chroma_subsampling=ChromaSubsamplingPreset(cfg.chroma_subsampling.value),
        quantization_preset=QuantizationTablePreset(cfg.quantization_preset.value),
        bits_per_channel=cfg.bits_per_channel,
        dct_variant=DCTVariant(cfg.dct_variant.value),
        num_shards=cfg.num_shards,
        scan_backend=cfg.scan_backend,
        quality=cfg.quality,
        one_dispatch=cfg.one_dispatch,
    )
