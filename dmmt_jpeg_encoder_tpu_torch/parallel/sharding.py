"""Multi-device encode: the image's MCU rows split over a list of devices.

Counterpart of dmmt_jpeg_encoder_tpu.parallel.sharding. The JAX package
ran one shard_map program over a 1-D mesh; here one process drives a list
of `num_shards` torch devices (shard_devices), each shard's work enqueued
on its own device's stream:

- every shard runs phase 1 on its MCU-aligned slab of the image padded
  (black) to rows_per_shard * num_shards MCU rows, BEFORE the DC DPCM
  (pipeline.phase1_blocks);
- the DC hand-off (the JAX package's ppermute): shard i's chains start
  from shard i-1's last raw DC of each channel, in final block order
  (MCU order for P420 luma), alignment blocks included; a vector of one
  DC per image for the slab;
- histograms over each shard's valid prefix (the alignment rows are whole
  trailing MCU rows, so validity is a prefix): the block-histogram kernel
  with a valid count per channel under DMMT_HIST=fused where the device
  runs the kernels (utils/capability.kernels_capable), else the masked
  symbol_histograms (the weighted-histogram kernel, mask as weights);
- the psum: every shard's histograms copied to the first shard's device
  and summed there; the one-dispatch encode builds the tables there once
  and hands each shard device its [4, 256] codes and lengths;
- each shard packs its own scan segment with the global tables, its
  alignment blocks masked out (the scan-pack kernel's `valid`); the host
  fetches each shard's bit count, then the words it needs, and bit-merges
  the segments (the JAX package's all_gather moves these same compressed
  segments).

The bytes cross devices as in the JAX package: the 4 histograms (64 + 1024
ints per image), one DC per channel and image, the compressed segments.

Phase 1 ignores DMMT_P1, as the JAX package's sharded phase 1 does (it
calls dct2d directly): ARAI runs the phase-1 kernel under every DMMT_P1,
SIMPLE and SEPARATED the matmul plane DCT kernel as on one device, and
FUSED (which the JAX package's dct2d does not know, so it computes the
Arai DCT) the phase-1 kernel too: the sharded FUSED bytes are the ARAI
bytes, as in the JAX package.

Paths, as in the JAX package: `start_sharded_encode` /
`finish_sharded_encode` run the one-dispatch encode (device tables from
the summed histograms, the scan-pack kernel per shard) where the devices
run the kernels, the fused pack is on (no DMMT_NO_FUSED_PACK) and the
image is within the device table build's bound, whatever one_dispatch
says; otherwise the two-dispatch encode (host tables from the summed
histograms, each shard's exact bits from its own histograms, the
scan-pack kernel or the staged pack per shard). `run_sharded_pipeline`
returns the blocks with the alignment blocks dropped and the summed
histograms (encoder.encode_array's host scan backend).
`start_sharded_encode_slab` / `finish_sharded_encode_slab` run B
same-geometry images row-stacked per shard: one phase 1 per shard, one
table build for all 4B tables, then B scan-pack calls per shard or one
slab scan-pack call (DMMT_SLAB_ONEPACK=1) with a [B, N] mask.

One program per start where every shard is on one card. The JAX package
compiles the sharded one-dispatch encode into ONE jitted program per key
(`_compiled_sharded_onedispatch`, `_compiled_sharded_onedispatch_slab`,
maxsize 16 and 8). The port's caches of those names hold, per key, a pool
of CUDA graphs captured from `_enqueue` (programs.py): a start copies the
samples into the MCU-padded input of a leased instance (whose padding is
zeroed once, when it is made) and replays it; the state holds the lease
until finish_sharded_encode(_slab) or until it is collected. The key is
the JAX key (without the multi-process program's `gather`) plus what
programs.program_key adds. The two-dispatch encode is two programs there,
as in the JAX package: `_compiled_sharded` (16; `_enqueue` without the
tables and packs) replayed by the start (and by run_sharded_pipeline),
and `_compiled_shard_pack` (16; every shard's pack from its blocks copied
in and the host tables) replayed by the finish. A device list that names several distinct cards keeps the
op-by-op enqueue: torch captures a graph on one device's stream and
memory pool, and the DC hand-off and the histogram sum cross cards in the
middle of the encode (programs.card decides). The CPU runs `_enqueue`
eagerly too, after the staging copies (upload_slabs). A failed capture
raises.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from .. import programs
from ..bitstream.device_pack import (
    check_scan_bits,
    exact_scan_bits,
    interleave_scan,
    pack_values,
    pad_and_stuff,
    stage_values,
    staged_pack_words,
    unpack_values,
    use_fused_pack,
    words_capacity,
)
from ..bitstream.fused_pack import fused_pack_words, fused_pack_words_slab
from ..config import ChromaSubsamplingPreset, DCTVariant, EncoderConfig
from ..entropy.categorize import symbol_histograms
from ..huffman.device_tables import device_code_tables_batched, pad_dc_histogram
from ..huffman.tables import HuffmanTables, split_histograms, tables_from_spec
from ..onedispatch import one_dispatch_supported, slab_max_blocks, slab_onepack_enabled
from ..ops.block_hist import fused_block_histograms
from ..ops.geometry import padded_size
from ..pipeline import DeviceEncodeResult, dc_dpcm_per_image, phase1_blocks
from ..tables import quantization_table_pair
from ..utils import capability
from ..utils.capability import mode_keyed_cache
from ..utils.device import narrow_pixels, on_device, pinned_copy, upload


def shard_devices(device, num_shards: int) -> list[torch.device]:
    """The device of each of num_shards shards. A list or tuple names them,
    one per shard, and may repeat a device: its shards then run one after
    another on that device's stream (several shards on one card). "cpu"
    puts every shard on the CPU (the kernels' plain versions). A CUDA
    device is the first of num_shards consecutive cards ("cuda": cards
    0..num_shards-1); ValueError when there are fewer cards, as the JAX
    package's build_mesh raises."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be at least 1, got {num_shards}")
    if isinstance(device, (list, tuple)):
        devices = [torch.device(d) for d in device]
        if len(devices) != num_shards:
            raise ValueError(f"{len(devices)} devices given for num_shards={num_shards}")
        return devices
    device = torch.device(device)
    if device.type == "cpu":
        return [device] * num_shards
    if device.type != "cuda":
        raise ValueError(f"no sharded encode on device type {device.type!r}")
    first = device.index or 0
    count = torch.cuda.device_count()
    if first + num_shards > count:
        raise ValueError(f"num_shards={num_shards} exceeds available devices ({count} from "
                         f"cuda:{first}); pass a list such as ['cuda:0'] * {num_shards} to put "
                         "several shards on one card")
    return [torch.device("cuda", first + i) for i in range(num_shards)]


def shard_geometry(
    height: int, width: int, preset: ChromaSubsamplingPreset, num_shards: int
) -> tuple[int, int, int, int]:
    """(global padded H, padded W, MCU rows per shard, valid MCU rows)."""
    ph, pw = padded_size(height, width, preset)
    valid_mcu_rows = ph // preset.mcu_height
    rows_per_shard = -(-valid_mcu_rows // num_shards)
    ph_aligned = rows_per_shard * num_shards * preset.mcu_height
    return ph_aligned, pw, rows_per_shard, valid_mcu_rows


@dataclass(frozen=True)
class Geometry:
    """One image's shard layout (shard_geometry) and per-shard block counts."""

    preset: ChromaSubsamplingPreset
    num_shards: int
    ph: int               # padded height, aligned to num_shards * rows_per_shard MCU rows
    pw: int
    rows_per_shard: int   # MCU rows per shard
    valid_mcu_rows: int   # MCU rows of the image padded to its MCU multiple

    @classmethod
    def of(cls, height: int, width: int, preset: ChromaSubsamplingPreset, num_shards: int):
        return cls(preset, num_shards, *shard_geometry(height, width, preset, num_shards))

    @property
    def shard_h(self) -> int:
        return self.rows_per_shard * self.preset.mcu_height

    @property
    def luma_per_row(self) -> int:
        """Luma blocks per MCU row."""
        return (self.pw // 8) * self.preset.vertical_rate

    @property
    def chroma_per_row(self) -> int:
        """Cb (or Cr) blocks per MCU row."""
        return self.pw // self.preset.horizontal_rate // 8

    @property
    def lpm(self) -> int:
        return self.preset.luma_blocks_per_mcu

    @property
    def n_scan(self) -> int:
        """Scan-order blocks of one image on one shard."""
        return self.rows_per_shard * (self.luma_per_row + 2 * self.chroma_per_row)

    def valid_rows(self, shard: int) -> int:
        """MCU rows of shard `shard` inside the image (the rest is alignment)."""
        return min(max(self.valid_mcu_rows - shard * self.rows_per_shard, 0), self.rows_per_shard)

    def scan_mask(self, shard: int, device: torch.device) -> torch.Tensor:
        """int32 [n_scan]: 1 for the shard's blocks inside the image (a prefix
        in scan order)."""
        return scan_prefix_mask(self.n_scan, shard, self.rows_per_shard, self.valid_mcu_rows,
                                self.pw // self.preset.mcu_width, self.lpm, device)


def scan_prefix_mask(n_scan: int, shard: int, rows_per_shard: int, valid_mcu_rows: int,
                     mcus_per_row: int, luma_per_mcu: int, device: torch.device) -> torch.Tensor:
    """int32 [n_scan]: 1 for shard `shard`'s scan-order blocks inside the
    image, a prefix of its valid MCU rows (Geometry.valid_rows), from the
    numbers the JAX package's shard pack is keyed on."""
    rows = min(max(valid_mcu_rows - shard * rows_per_shard, 0), rows_per_shard)
    valid = rows * mcus_per_row * (luma_per_mcu + 2)
    return (torch.arange(n_scan, device=device) < valid).to(torch.int32)


def drop_alignment_blocks(
    blocks: np.ndarray,
    num_shards: int,
    rows_per_shard: int,
    valid_mcu_rows: int,
    blocks_per_mcu_row: int,
) -> np.ndarray:
    """Keep each shard's valid prefix of the shards' blocks concatenated
    (alignment padding is whole trailing MCU rows, so validity is a prefix
    in MCU order)."""
    per_shard = blocks.shape[0] // num_shards
    keep = []
    for s in range(num_shards):
        valid_rows = min(max(valid_mcu_rows - s * rows_per_shard, 0), rows_per_shard)
        keep.append(blocks[s * per_shard: s * per_shard + valid_rows * blocks_per_mcu_row])
    return np.concatenate(keep, axis=0)


def merge_bit_streams(chunks: list) -> tuple[np.ndarray, int]:
    """Bit-aligned concatenation of (uint8 stream, bit_length) chunks.

    Streams are MSB-first; bits beyond bit_length must be zero (the scan
    packs leave masked blocks out, so they are). Vectorized per chunk: each
    byte contributes its top bits to out[i] and its low bits to out[i+1]."""
    total_bits = int(sum(b for _, b in chunks))
    out = np.zeros((total_bits + 7) // 8 + 1, np.uint8)
    pos = 0
    for data, bits in chunks:
        bits = int(bits)
        if bits == 0:
            continue
        nb = (bits + 7) // 8
        data = np.asarray(data, dtype=np.uint8)[:nb]
        k = pos & 7
        byte0 = pos >> 3
        if k == 0:
            out[byte0: byte0 + nb] |= data
        else:
            out[byte0: byte0 + nb] |= data >> k
            out[byte0 + 1: byte0 + 1 + nb] |= ((data.astype(np.uint16) << (8 - k)) & 0xFF).astype(np.uint8)
        pos += bits
    return out[: (total_bits + 7) // 8], total_bits


def merge_and_stuff(chunks: list) -> bytes:
    """The scan tail of a sharded encode: bit-merge the shards' streams,
    1-pad the final byte (reference: encoder.rs:267), byte-stuff 0xFFs
    (segment_marker_injector.rs:14-30)."""
    return pad_and_stuff(*merge_bit_streams(chunks))


# --- phase 1 and the histograms ---------------------------------------------


def phase1_route(variant: DCTVariant) -> tuple[DCTVariant, str | None]:
    """(variant, DMMT_P1 mode) for pipeline.phase1_blocks on a shard: the
    JAX package's sharded phase 1 ignores DMMT_P1 and runs dct2d, which
    knows SIMPLE and SEPARATED and computes the Arai DCT for the rest."""
    if variant in (DCTVariant.SIMPLE, DCTVariant.SEPARATED):
        return variant, None
    return DCTVariant.ARAI, "plane"


def upload_slabs(
    frames: list[np.ndarray], maxval: int, geom: Geometry, devices: list[torch.device]
) -> list[torch.Tensor]:
    """B host images [H, W, 3] of one shape -> each shard's [B * shard_h,
    pw, 3] row stack of its MCU-row slice of every image, padded black to
    the aligned size, on its device. Each sample is copied once, into a
    host buffer (pinned for a card) of which only the padding is zeroed,
    and uploaded asynchronously; all uploads are enqueued before any
    phase 1."""
    frames = [narrow_pixels(np.asarray(px), maxval) for px in frames]
    height, width = frames[0].shape[:2]
    dtype = torch.from_numpy(frames[0][:0, 0, 0]).dtype
    sh = geom.shard_h
    out = []
    for s, dev in enumerate(devices):
        r0, r1 = min(s * sh, height), min((s + 1) * sh, height)
        host = torch.empty((len(frames), sh, geom.pw, 3), dtype=dtype,
                           pin_memory=torch.device(dev).type == "cuda")
        buf = host.numpy()
        for i, px in enumerate(frames):
            buf[i, : r1 - r0, :width] = px[r0:r1]
        buf[:, r1 - r0:] = 0
        buf[:, : r1 - r0, width:] = 0
        out.append(host.reshape(-1, geom.pw, 3).to(dev, non_blocking=True))
    return out


def shard_slabs(x: torch.Tensor, geom: Geometry) -> list[torch.Tensor]:
    """Each shard's slab of an MCU-padded image on one device, as
    upload_slabs gives them: of [n * shard_h, pw, 3] its rows (a view), of
    a stack [B, n * shard_h, pw, 3] its rows of every image, row-stacked
    (a copy)."""
    sh = geom.shard_h
    if x.dim() == 3:
        return [x[s * sh: (s + 1) * sh] for s in range(geom.num_shards)]
    return [x[:, s * sh: (s + 1) * sh].reshape(-1, geom.pw, 3) for s in range(geom.num_shards)]


def raw_blocks(
    slabs: list[torch.Tensor], maxval: int, config: EncoderConfig,
    luma_q: np.ndarray, chroma_q: np.ndarray, devices: list[torch.device],
) -> list[tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Each shard's phase 1 (phase1_route), enqueued on its device: (luma
    in MCU order, cb, cr) int16 [N, 64] zigzag blocks before the DPCM."""
    variant, mode = phase1_route(config.dct_variant)
    out = []
    for rgb, dev in zip(slabs, devices):
        with on_device(dev):
            out.append(phase1_blocks(rgb, maxval, luma_q, chroma_q, config.chroma_subsampling,
                                     variant, mode))
    return out


def last_dcs(blocks: tuple, n_images: int) -> torch.Tensor:
    """int32 [3, n_images]: each channel's last raw DC of each image (the
    next shard's first predictors)."""
    return torch.stack([x[:, 0].to(torch.int32).reshape(n_images, -1)[:, -1] for x in blocks])


def chain_dc(
    raw: list[tuple], n_images: int, devices: list[torch.device],
    first: torch.Tensor | None = None,
) -> list[tuple]:
    """DC DPCM of every shard's blocks, each image's chain continuing across
    shards: shard i starts from shard i-1's last raw DCs (copied to shard
    i's device), shard 0 from `first` (int [3, n_images]; None: 0)."""
    out = []
    prev = first
    for blocks, dev in zip(raw, devices):
        with on_device(dev):
            start = None if prev is None else prev.to(dev, non_blocking=True)
            out.append(tuple(dc_dpcm_per_image(x, n_images, None if start is None else start[c])
                             for c, x in enumerate(blocks)))
            prev = last_dcs(blocks, n_images)
    return out


def shard_histograms(
    blocks: tuple, n_images: int, geom: Geometry, shard: int, device: torch.device,
    hist_state: torch.Tensor | None = None,
) -> torch.Tensor:
    """int32 [n_images, 544] histograms (huffman/tables.HIST_SPLITS) of one
    shard's DPCM'd blocks, each image's over its valid prefix: the
    block-histogram kernel with a valid count per channel (Cb and Cr apart,
    then added) under DMMT_HIST=fused on a device that runs the kernels,
    else the masked symbol_histograms. `hist_state`: the histogram
    kernels' state (a captured program's own; default the stream's)."""
    luma, cb, cr = blocks
    nl, nc = int(luma.shape[0]) // n_images, int(cb.shape[0]) // n_images
    rows = geom.valid_rows(shard)
    n_luma, n_chroma = rows * geom.luma_per_row, rows * geom.chroma_per_row
    fused = os.environ.get("DMMT_HIST", "fused") == "fused" and capability.kernels_capable(device)
    if not fused:
        luma_mask = torch.arange(nl, device=device) < n_luma
        chroma_mask = torch.arange(nc, device=device) < n_chroma
        chroma_mask = torch.cat([chroma_mask, chroma_mask])
    out = []
    with on_device(device):
        for i in range(n_images):
            lz, cbz, crz = luma[i * nl: (i + 1) * nl], cb[i * nc: (i + 1) * nc], cr[i * nc: (i + 1) * nc]
            if fused:
                l_dc, l_ac = fused_block_histograms(lz, n_luma, state=hist_state)
                b_dc, b_ac = fused_block_histograms(cbz, n_chroma, state=hist_state)
                r_dc, r_ac = fused_block_histograms(crz, n_chroma, state=hist_state)
                c_dc, c_ac = b_dc + r_dc, b_ac + r_ac
            else:
                l_dc, l_ac = symbol_histograms(lz, luma_mask, state=hist_state)
                c_dc, c_ac = symbol_histograms(torch.cat([cbz, crz]), chroma_mask,
                                               state=hist_state)
            out.append(torch.cat([l_dc, l_ac, c_dc, c_ac]).to(torch.int32))
    return torch.stack(out)


def gather_histograms(hists: list[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The psum: every shard's [B, 544] histograms on `device`, stacked
    [n, B, 544] (their sum over shards is the image's)."""
    return torch.stack([h.to(device, non_blocking=True) for h in hists])


def device_tables(global_hists: torch.Tensor) -> dict[str, torch.Tensor]:
    """One table build for all images: [B, 544] summed histograms ->
    device_code_tables_batched of the 4B tables (luma DC, luma AC, chroma
    DC, chroma AC per image)."""
    stack = []
    for row in global_hists:
        l_dc, l_ac, c_dc, c_ac = split_histograms(row)
        stack += [pad_dc_histogram(l_dc), l_ac, pad_dc_histogram(c_dc), c_ac]
    return device_code_tables_batched(torch.stack(stack))


def scans_of(blocks: tuple, n_images: int, geom: Geometry) -> torch.Tensor:
    """A shard's DPCM'd blocks -> int16 [B, n_scan, 64] scan-order blocks
    per image (each image's MCUs are contiguous in all three channels)."""
    luma, cb, cr = blocks
    return interleave_scan(luma, cb, cr, int(cb.shape[0]), geom.lpm).reshape(n_images, -1, 64)


def pack_shard(
    blocks: tuple, n_images: int, geom: Geometry, shard: int, device: torch.device,
    codes: torch.Tensor, lens: torch.Tensor, onepack: bool,
) -> tuple[list[torch.Tensor], torch.Tensor]:
    """One shard's scan-pack calls with the global tables (codes/lens
    [B, 4, 256] on `device`), its alignment blocks masked: B scan-pack
    calls, or one slab scan-pack call (onepack). Returns (each image's
    words int32 [n_scan * 64 + 2], total_bits int64 [B])."""
    n_words = geom.n_scan * 64 + 2
    with on_device(device):
        scans = scans_of(blocks, n_images, geom)
        mask = geom.scan_mask(shard, device)
        stride = geom.lpm + 2
        if onepack:
            words, bits = fused_pack_words_slab(scans, stride, geom.lpm, codes, lens, n_words,
                                                valid=mask.expand(n_images, -1))
            return list(words), bits
        packs = [fused_pack_words(scans[i], stride, geom.lpm, codes[i], lens[i], n_words,
                                  valid=mask) for i in range(n_images)]
    return [w for w, _ in packs], torch.cat([b for _, b in packs])


# --- the sharded encodes -----------------------------------------------------


@dataclass
class ShardedState:
    """An enqueued sharded encode of n_images same-geometry images. The
    states a program's replays return share `blocks`, `words` and `bits`
    with its capture's (and their tensors are the graph's outputs), so
    nothing changes a state's lists after `_enqueue`: the two-dispatch
    finish packs into lists of its own. A finish keeps its result on the
    state, and a later finish returns it."""

    kind: str                      # "onedispatch" or "twodispatch"
    geom: Geometry
    devices: list[torch.device]
    n_images: int
    blocks: list[tuple]            # per shard (luma, cb, cr), DPCM'd
    hists: torch.Tensor            # int32 [n, B, 544] per-shard histograms, on devices[0]
    words: list[list[torch.Tensor]] = field(default_factory=list)  # [shard][image]
    bits: list[torch.Tensor] = field(default_factory=list)         # [shard] int64 [B]
    tables: dict | None = None     # device tables of the one-dispatch encode
    small: torch.Tensor | None = None        # host copy of bits + table spec
    small_ready: torch.cuda.Event | None = None
    # [(scan bytes, HuffmanTables)] per image of the first finish
    result: list | None = None
    # gives the start's program instance back (a weakref.finalize: runs
    # once, at the finish or when the state is collected); None when eager
    release: Callable | None = field(default=None, repr=False, compare=False)


def kernels_on(devices: list[torch.device]) -> bool:
    """Every shard device runs the kernels (utils/capability)."""
    return all(capability.kernels_capable(d) for d in dict.fromkeys(devices))


def onedispatch_allowed(config: EncoderConfig, height: int, width: int) -> bool:
    """DMMT_NO_FUSED_PACK not set and the image within the device table
    build's bound. As in the JAX package's sharded routing, one_dispatch
    and DMMT_NO_ONEDISPATCH are not read: the sharded two-dispatch encode
    runs only past the bound, under DMMT_NO_FUSED_PACK, or where the
    devices do not run the kernels."""
    return use_fused_pack() and one_dispatch_supported(height, width, config.chroma_subsampling)


def use_sharded_onedispatch(config: EncoderConfig, height: int, width: int,
                            devices: list[torch.device]) -> bool:
    """The one-dispatch sharded encode: onedispatch_allowed, and the
    devices run the kernels."""
    return onedispatch_allowed(config, height, width) and kernels_on(devices)


def _enqueue(slabs: list[torch.Tensor], n_images: int, maxval: int, config: EncoderConfig,
             luma_q: np.ndarray, chroma_q: np.ndarray, geom: Geometry,
             devices: list[torch.device], onedispatch: bool, onepack: bool = False,
             hist_state: torch.Tensor | None = None) -> ShardedState:
    """Each shard's phase 1 on its slab ([n_images * shard_h, pw, 3] on its
    device), the DC hand-off and the histograms, gathered on the first
    shard's device; then (onedispatch) one table build there and every
    shard's pack (B scan-pack calls, or one slab call: onepack). The eager
    enqueue, and what a program captures (with its own `hist_state`)."""
    blocks = chain_dc(raw_blocks(slabs, maxval, config, luma_q, chroma_q, devices), n_images,
                      devices)
    hists = gather_histograms([shard_histograms(x, n_images, geom, s, dev, hist_state)
                               for s, (x, dev) in enumerate(zip(blocks, devices))], devices[0])
    kind = "onedispatch" if onedispatch else "twodispatch"
    if not onedispatch:
        return ShardedState(kind, geom, devices, n_images, blocks, hists)
    with on_device(devices[0]):
        tables = device_tables(hists.sum(dim=0))
    codes = tables["codes_flat"].reshape(n_images, 4, 256)
    lens = tables["lens_flat"].reshape(n_images, 4, 256)
    words, bits = [], []
    for s, (x, dev) in enumerate(zip(blocks, devices)):
        w, b = pack_shard(x, n_images, geom, s, dev, codes.to(dev, non_blocking=True),
                          lens.to(dev, non_blocking=True), onepack)
        words.append(w)
        bits.append(b)
    return ShardedState(kind, geom, devices, n_images, blocks, hists, words, bits, tables)


def _start(frames: list[np.ndarray], maxval: int, config: EncoderConfig,
           devices: list[torch.device], onedispatch: bool, luma_q: np.ndarray | None = None,
           chroma_q: np.ndarray | None = None) -> ShardedState:
    """The eager start of B images of one shape: every shard's staging copy
    and upload (upload_slabs), `_enqueue`, and (onedispatch) the small
    copy. The quantization tables default to the config's."""
    b, (height, width) = len(frames), frames[0].shape[:2]
    geom = Geometry.of(height, width, config.chroma_subsampling, config.num_shards)
    if luma_q is None or chroma_q is None:
        luma_q, chroma_q = quantization_table_pair(config.quantization_preset, config.quality)
    slabs = upload_slabs(frames, maxval, geom, devices)
    state = _enqueue(slabs, b, maxval, config, luma_q, chroma_q, geom, devices, onedispatch,
                     onepack=onedispatch and b > 1 and slab_onepack_enabled())
    if onedispatch:
        _prefetch(state)
    return state


def _replay(pool, pixels, maxval: int) -> ShardedState:
    """Lease an instance of `pool`, copy the samples in, replay it, and
    (one-dispatch) enqueue the small copy behind it."""
    state = programs.start(pool, pixels, maxval)[0]
    if state.kind == "onedispatch":
        _prefetch(state)
    return state


def _sharded_start(pixels: np.ndarray, maxval: int, config: EncoderConfig,
                   devices: list[torch.device], onedispatch: bool,
                   luma_q: np.ndarray | None = None,
                   chroma_q: np.ndarray | None = None) -> ShardedState:
    """One image's sharded start: with every shard on one card one replay
    of the program (_compiled_sharded_onedispatch, or _compiled_sharded for
    the two-dispatch encode); otherwise `_start`, op by op."""
    if luma_q is None or chroma_q is None:
        luma_q, chroma_q = quantization_table_pair(config.quantization_preset, config.quality)
    card = programs.card(pixels, devices)
    if card is None:
        return _start([pixels], maxval, config, devices, onedispatch, luma_q, chroma_q)
    kernels_on(devices)  # the probe, outside any capture (the enqueue reads its result)
    cache = _compiled_sharded_onedispatch if onedispatch else _compiled_sharded
    pool = cache(int(pixels.shape[0]), int(pixels.shape[1]), config.chroma_subsampling,
                 config.dct_variant, config.num_shards,
                 *programs.program_key(pixels, maxval, luma_q, chroma_q, card))
    return _replay(pool, pixels, maxval)


def _sharded_pool(kind: str, shape: tuple, n_images: int, height: int, width: int,
                  preset: ChromaSubsamplingPreset, variant: DCTVariant, num_shards: int,
                  device: torch.device, dtype: torch.dtype, maxval: int, luma_key: tuple,
                  chroma_key: tuple, onepack: bool, onedispatch: bool = True):
    """A pool of the sharded program over an MCU-padded input of `shape`
    ([ph, pw, 3], or [B, ph, pw, 3] for the slab): shard_slabs, then
    `_enqueue` with every shard on the program's card (onedispatch False:
    the two-dispatch encode's phase 1 and histograms). A start writes its
    samples into the input's [:height, :width] (each image's, for the
    slab), so the padding stays black."""
    config = EncoderConfig(chroma_subsampling=preset, dct_variant=variant, num_shards=num_shards)
    geom = Geometry.of(height, width, preset, num_shards)
    lq, cq = programs.key_table(luma_key), programs.key_table(chroma_key)

    def enqueue(x, state):
        return [_enqueue(shard_slabs(x, geom), n_images, maxval, config, lq, cq, geom,
                         [x.device] * num_shards, onedispatch, onepack, state)]

    def fill(x, pixels, maxval):
        if len(shape) == 3:
            programs.copy_in(x[:height, :width], pixels, maxval)
        else:
            for i, px in enumerate(pixels):
                programs.copy_in(x[i, :height, :width], px, maxval)

    return programs.pool(kind, shape, dtype, device, enqueue, fill)


@mode_keyed_cache(maxsize=16)
def _compiled_sharded(height: int, width: int, preset: ChromaSubsamplingPreset,
                      variant: DCTVariant, num_shards: int, device: torch.device,
                      dtype: torch.dtype, maxval: int, luma_key: tuple, chroma_key: tuple):
    """The sharded two-dispatch encode's first half of one image on one
    card: every shard's phase 1, the DC hand-off and the per-shard
    histograms, gathered."""
    geom = Geometry.of(height, width, preset, num_shards)
    return _sharded_pool("sharded", (geom.ph, geom.pw, 3), 1, height, width, preset, variant,
                         num_shards, device, dtype, maxval, luma_key, chroma_key, False,
                         onedispatch=False)


@mode_keyed_cache(maxsize=16)
def _compiled_sharded_onedispatch(height: int, width: int, preset: ChromaSubsamplingPreset,
                                  variant: DCTVariant, num_shards: int, device: torch.device,
                                  dtype: torch.dtype, maxval: int, luma_key: tuple,
                                  chroma_key: tuple):
    """The sharded one-dispatch program of one image on one card."""
    geom = Geometry.of(height, width, preset, num_shards)
    return _sharded_pool("sharded_onedispatch", (geom.ph, geom.pw, 3), 1, height, width, preset,
                         variant, num_shards, device, dtype, maxval, luma_key, chroma_key, False)


@mode_keyed_cache(maxsize=8)
def _compiled_sharded_onedispatch_slab(n_images: int, height: int, width: int,
                                       preset: ChromaSubsamplingPreset, variant: DCTVariant,
                                       num_shards: int, device: torch.device, dtype: torch.dtype,
                                       maxval: int, luma_key: tuple, chroma_key: tuple):
    """The sharded slab program of n_images same-geometry images on one
    card (DMMT_SLAB_ONEPACK read at capture: one slab scan-pack call per
    shard)."""
    geom = Geometry.of(height, width, preset, num_shards)
    return _sharded_pool("sharded_onedispatch_slab", (n_images, geom.ph, geom.pw, 3), n_images,
                         height, width, preset, variant, num_shards, device, dtype, maxval,
                         luma_key, chroma_key, n_images > 1 and slab_onepack_enabled())


def _prefetch(state: ShardedState) -> None:
    """Enqueue one copy of every shard's bit counts and every image's table
    spec into pinned host memory (on the first shard's device) and record
    an event behind it."""
    dev0 = state.devices[0]
    t = state.tables
    with on_device(dev0):
        state.small, state.small_ready = pinned_copy([
            torch.stack([x.to(dev0, non_blocking=True) for x in state.bits]),
            t["n_present"], t["sym_by_leaf"], t["len_by_leaf"]])


def _fetch_segments(devices: list[torch.device], words: list[list[torch.Tensor]],
                    needed: np.ndarray) -> list[list[np.ndarray]]:
    """[shard][image] uint8 streams: of words[shard][image] the first
    needed[s, i] words, one device->host copy per shard."""
    out = []
    for s, dev in enumerate(devices):
        with on_device(dev):
            parts = [w[: int(n)] for w, n in zip(words[s], needed[s])]
            host = torch.cat(parts).cpu().numpy()
        offs = np.concatenate([[0], np.cumsum(needed[s])])
        out.append([host[offs[i]: offs[i + 1]].view(np.uint8) for i in range(len(words[s]))])
    return out


def _finish_onedispatch(state: ShardedState) -> list[tuple[bytes, object]]:
    """Wait for the small copy, fetch the needed words of every shard and
    image, and bit-merge each image's segments -> [(scan bytes,
    HuffmanTables)] per image, kept on the state for a later finish. Then
    give a program's instance back: the state's device tensors belong to
    the next start that replays it."""
    if state.result is not None:
        return state.result
    if state.small_ready is not None:
        state.small_ready.synchronize()
    small = state.small.numpy()
    n, b = len(state.devices), state.n_images
    bits = small[: n * b].reshape(n, b)
    rest = small[n * b:]
    spec_ns = rest[: 4 * b].reshape(b, 4)
    spec_syms = rest[4 * b: 4 * b + 1024 * b].reshape(b, 4, 256)
    spec_lens = rest[4 * b + 1024 * b:].reshape(b, 4, 256)
    needed = (bits + 31) // 32
    segments = _fetch_segments(state.devices, state.words, needed)
    results = []
    for i in range(b):
        tables = tables_from_spec(spec_syms[i], spec_lens[i], spec_ns[i])
        # the shards' histograms of image i: the prediction is their sum's
        check_scan_bits(bits[:, i].sum(), (split_histograms(state.hists[:, i]), tables),
                        f"sharded one-dispatch image {i}")
        results.append((merge_and_stuff([(segments[s][i], int(bits[s, i])) for s in range(n)]),
                        tables))
    state.result = results
    if state.release is not None:
        state.release()  # its instance may replay again
    return results


def shard_pack(blocks: tuple, shard: int, codes: torch.Tensor, lens: torch.Tensor,
               n_words: int, fused: bool, luma_per_mcu: int, rows_per_shard: int,
               valid_mcu_rows: int, mcus_per_row: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One shard's two-dispatch pack with the host tables (codes/lens
    [4, 256] on its device), its alignment blocks masked: the scan-pack
    kernel (fused), else the staged pack -> (words int32 [n_words],
    total_bits int64 [1])."""
    luma, cb, cr = blocks
    scan = interleave_scan(luma, cb, cr, int(cb.shape[0]), luma_per_mcu)
    mask = scan_prefix_mask(int(scan.shape[0]), shard, rows_per_shard, valid_mcu_rows,
                            mcus_per_row, luma_per_mcu, scan.device)
    pack = fused_pack_words if fused else staged_pack_words
    return pack(scan, luma_per_mcu + 2, luma_per_mcu, codes, lens, n_words, valid=mask)


@mode_keyed_cache(maxsize=16)
def _compiled_shard_pack(num_shards: int, nl_s: int, nc_s: int, luma_per_mcu: int,
                         words_cap: int, rows_per_shard: int, valid_mcu_rows: int,
                         mcus_per_row: int, use_fused: bool, device: torch.device):
    """Every shard's two-dispatch pack on one card (shard_pack per shard),
    from the shards' blocks copied in and the host tables. Keyed as the
    JAX package's program, plus the device. Inputs: luma [n, nl_s, 64],
    cb and cr [n, nc_s, 64], device_pack.pack_values' vector of one image
    and its host staging."""
    n_values = 2 * 4 * 256 + 1
    shapes = ((num_shards, nl_s, 64), (num_shards, nc_s, 64), (num_shards, nc_s, 64),
              (n_values,), (n_values,))
    dtypes = (torch.int16, torch.int16, torch.int16, torch.int32, programs.HostStaging(torch.int32))

    def enqueue(inputs, _state):
        luma, cb, cr, values, _ = inputs
        codes, lens, _ = unpack_values(values, 1)
        packs = [shard_pack((luma[s], cb[s], cr[s]), s, codes[0], lens[0], words_cap, use_fused,
                            luma_per_mcu, rows_per_shard, valid_mcu_rows, mcus_per_row)
                 for s in range(num_shards)]
        return [([w for w, _ in packs], [b for _, b in packs])]

    def fill(inputs, args, _maxval):
        luma, cb, cr, values, staging = inputs
        blocks, host = args
        for s, (lz, cbz, crz) in enumerate(blocks):
            luma[s].copy_(lz)
            cb[s].copy_(cbz)
            cr[s].copy_(crz)
        stage_values(values, staging, host)

    return programs.pool("shard_pack", shapes, dtypes, device, enqueue, fill)


def _finish_twodispatch(state: ShardedState) -> tuple[bytes, object]:
    """One fetch of every shard's histograms; host tables from their sum
    and each shard's exact bits from its own; every shard's pack (the
    scan-pack kernel, or with DMMT_NO_FUSED_PACK the staged pack) with the
    host tables, its alignment blocks masked; fetch and bit-merge. With
    every shard on one card the packs are one replay of _compiled_shard_pack;
    otherwise op by op. The result stays on the state for a later finish,
    and a program's instance is given back."""
    if state.result is not None:
        return state.result[0]
    geom, devices = state.geom, state.devices
    per_shard = state.hists[:, 0].cpu().numpy().astype(np.int64)  # [n, 544]
    tables = HuffmanTables.from_host_histograms(*split_histograms(per_shard.sum(axis=0)))
    flat = tables.flat()
    bits = [exact_scan_bits(split_histograms(h), *flat) for h in per_shard]
    values = pack_values([flat], [0])
    # the scan-pack kernel where the devices run the kernels and
    # DMMT_NO_FUSED_PACK is not set (the JAX package's _use_fused_pack),
    # with the worst-case word buffer of the shape; the staged pack with
    # the JAX package's bucket of the longest shard's words
    fused = kernels_on(devices) and use_fused_pack()
    words_cap = (geom.n_scan * 64 + 2 if fused
                 else words_capacity(max((b + 31) // 32 + 2 for b in bits)))
    key = (geom.rows_per_shard, geom.valid_mcu_rows, geom.pw // geom.preset.mcu_width)

    def read(words: list[torch.Tensor], packed: list[torch.Tensor]) -> tuple[bytes, object]:
        for s, p in enumerate(packed):
            check_scan_bits(p, bits[s], f"shard {s}")
        needed = np.array([[(b + 31) // 32] for b in bits])
        segments = _fetch_segments(devices, [[w] for w in words], needed)
        return merge_and_stuff([(segments[s][0], bits[s]) for s in range(len(devices))]), tables

    card = programs.card(state.blocks[0][0], devices)
    if card is None:
        packs = []
        for s, (blocks, dev) in enumerate(zip(state.blocks, devices)):
            with on_device(dev):
                codes, lens, _ = unpack_values(upload(values, dev), 1)
                packs.append(shard_pack(blocks, s, codes[0], lens[0], words_cap, fused, geom.lpm,
                                        *key))
        result = read([w for w, _ in packs], [b for _, b in packs])
    else:
        pool = _compiled_shard_pack(geom.num_shards, int(state.blocks[0][0].shape[0]),
                                    int(state.blocks[0][1].shape[0]), geom.lpm, words_cap, *key,
                                    fused, card)
        result = programs.run_once(pool, (state.blocks, values), read)
    state.result = [result]
    if state.release is not None:
        state.release()  # its instance may replay again
    return result


def start_sharded_encode(
    pixels: np.ndarray, maxval: int, config: EncoderConfig, device="cuda"
) -> ShardedState:
    """Enqueue the sharded encode of RGB [H, W, 3] host samples on
    shard_devices(device, config.num_shards) without waiting: the
    one-dispatch encode where use_sharded_onedispatch holds (every shard
    packed), otherwise the two-dispatch encode's phase 1 and histograms.
    With every shard on one card the start is one replay of a program
    (_compiled_sharded_onedispatch, or _compiled_sharded for the
    two-dispatch encode); across several cards and on the CPU it is
    enqueued op by op. Finish with finish_sharded_encode."""
    devices = shard_devices(device, config.num_shards)
    h, w = int(pixels.shape[0]), int(pixels.shape[1])
    return _sharded_start(pixels, maxval, config, devices,
                          use_sharded_onedispatch(config, h, w, devices))


def finish_sharded_encode(state: ShardedState, config: EncoderConfig) -> tuple[bytes, object]:
    """(stuffed scan bytes, HuffmanTables) of a start_sharded_encode; a
    state finished again gives its first result."""
    if state.kind == "onedispatch":
        return _finish_onedispatch(state)[0]
    return _finish_twodispatch(state)


def encode_sharded_scan(
    pixels: np.ndarray, maxval: int, config: EncoderConfig, device="cuda"
) -> tuple[bytes, object]:
    """The sharded encode of the entropy scan -> (stuffed scan bytes,
    HuffmanTables)."""
    return finish_sharded_encode(start_sharded_encode(pixels, maxval, config, device), config)


def start_sharded_encode_slab(
    pixels_stack, maxval: int, config: EncoderConfig, device="cuda"
) -> ShardedState:
    """Enqueue the one-dispatch sharded encode of B same-geometry images
    ([B, H, W, 3] host samples, or a list of B [H, W, 3] arrays): each shard row-stacks its slice of every
    image and runs one phase 1, the 4B tables come from one build, and each
    shard packs its B segments (DMMT_SLAB_ONEPACK=1: in one slab scan-pack
    call). With every shard on one card: one replay of the program
    (_compiled_sharded_onedispatch_slab), whose one state holds the lease.
    Raises ValueError when a shard's group exceeds the slab bound
    (onedispatch.slab_max_blocks)."""
    devices = shard_devices(device, config.num_shards)
    frames = list(pixels_stack)
    b, (h, w) = len(frames), frames[0].shape[:2]
    geom = Geometry.of(h, w, config.chroma_subsampling, config.num_shards)
    limit = slab_max_blocks()
    if b * geom.n_scan > limit:
        raise ValueError(f"start_sharded_encode_slab: {b} x {geom.n_scan} blocks per shard "
                         f"exceeds the {limit}-block group bound (DMMT_SLAB_MAX_BLOCKS); "
                         "split the group")
    if not use_sharded_onedispatch(config, h, w, devices):
        raise ValueError("the sharded slab needs the one-dispatch sharded encode "
                         "(use_sharded_onedispatch)")
    card = programs.card(frames[0], devices)
    if card is None:
        return _start(frames, maxval, config, devices, onedispatch=True)
    lq, cq = quantization_table_pair(config.quantization_preset, config.quality)
    key = programs.program_key(frames[0], maxval, lq, cq, card)
    pool = _compiled_sharded_onedispatch_slab(b, h, w, config.chroma_subsampling,
                                              config.dct_variant, config.num_shards, *key)
    return _replay(pool, frames, maxval)


def finish_sharded_encode_slab(state: ShardedState, config: EncoderConfig) -> list[tuple[bytes, object]]:
    """[(stuffed scan bytes, HuffmanTables)] per image of a
    start_sharded_encode_slab, each equal to the image's own encode."""
    return _finish_onedispatch(state)


def run_sharded_pipeline(
    pixels: np.ndarray,
    maxval: int,
    config: EncoderConfig,
    luma_q: np.ndarray | None = None,
    chroma_q: np.ndarray | None = None,
    device="cuda",
) -> DeviceEncodeResult:
    """The sharded phase 1 and histograms -> the blocks (CPU tensors, with
    drop_alignment_blocks applied) and the summed histograms (numpy), equal
    to the single-device result."""
    devices = shard_devices(device, config.num_shards)
    state = _sharded_start(pixels, maxval, config, devices, False, luma_q, chroma_q)
    g = state.geom
    out = [
        torch.from_numpy(drop_alignment_blocks(
            torch.cat([blocks[c].cpu() for blocks in state.blocks]).numpy(),
            g.num_shards, g.rows_per_shard, g.valid_mcu_rows, per_row))
        for c, per_row in enumerate((g.luma_per_row, g.chroma_per_row, g.chroma_per_row))
    ]
    hists = split_histograms(state.hists.sum(dim=0)[0].cpu().numpy())
    return DeviceEncodeResult(*out, *hists)
