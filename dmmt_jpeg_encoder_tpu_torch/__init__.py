"""dmmt_jpeg_encoder_tpu_torch — the JPEG encoder on PyTorch and CUDA.

A port of dmmt_jpeg_encoder_tpu (JAX on a TPU, kept in the repository as
the reference) to an NVIDIA H100: P3 PPM / RGB array -> baseline JFIF
with per-image optimal Huffman tables, P444/P422/P420 and the seven
quantization presets. The default single-image encode and the batch
encode run as plain torch around hand-written CUDA kernels (csrc/: phase
1, histograms, scan pack and its slab form), and their bytes equal the JAX
package's.

Public functions take `device` (default "cuda"); "cpu" runs each kernel's
plain torch version. This package imports torch and never jax.
"""

from .config import (
    ChromaSubsamplingPreset,
    DCTVariant,
    EncoderConfig,
    QuantizationTablePreset,
    SubsamplingMethod,
)
from .encoder import (
    HuffmanTables,
    convert_ppm_to_jpeg,
    encode_array,
    encode_batch,
    encode_ppm_bytes,
    encode_ppm_image,
)
from .io.ppm import PPMImage, read_ppm, read_ppm_bytes, write_ppm

__version__ = "0.1.0"

__all__ = [
    "ChromaSubsamplingPreset",
    "DCTVariant",
    "EncoderConfig",
    "QuantizationTablePreset",
    "SubsamplingMethod",
    "HuffmanTables",
    "convert_ppm_to_jpeg",
    "encode_array",
    "encode_batch",
    "encode_ppm_bytes",
    "encode_ppm_image",
    "PPMImage",
    "read_ppm",
    "read_ppm_bytes",
    "write_ppm",
    "__version__",
]
