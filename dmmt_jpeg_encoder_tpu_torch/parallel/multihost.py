"""Multi-process encode: torch.distributed wiring + per-process rows.

Counterpart of dmmt_jpeg_encoder_tpu.parallel.multihost, with
torch.distributed in place of jax.distributed. Each process drives its own
shards (`config.num_shards / process_count()` of them, on its own device
or devices) and supplies only its own image rows (`local_row_range`).
`encode_array_distributed` runs the one-dispatch sharded encode of
parallel/sharding.py on the process's shards, and the collectives carry
what the JAX package's mesh carried:

- the DC hand-off: an all_gather of each process's last shard's last raw
  DC per channel (3 ints), so each process's first shard continues the
  previous process's chain;
- the psum: an all_reduce of the summed histograms (64 + 1024 ints);
- the compressed segments: an all_gather of every shard's bit count, then
  of its words up to the longest segment, so process 0 can bit-merge them
  and assemble the JPEG (every other process returns None).

With the gloo backend the collectives carry host copies of these small
tensors; with NCCL (one card per process) they stay on the card. On the
CPU (gloo, device="cpu") the kernels' plain versions run. The bytes equal
a single-process encode_array of the whole image.

Typical use (the same script in every process):

    from dmmt_jpeg_encoder_tpu_torch.parallel import multihost as mh
    mh.initialize_distributed("tcp://localhost:29500", world_size, rank)
    config = EncoderConfig(num_shards=mh.global_mesh_shards())
    r0, r1 = mh.local_row_range(height, width, config)
    jpeg = mh.encode_array_distributed(load_rows(r0, r1), height, width, 255, config,
                                       device=f"cuda:{local_card}")
    # bytes on process 0, None elsewhere
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..config import EncoderConfig
from ..tables import quantization_table_pair
from ..utils.device import as_device, narrow_pixels, on_device


def initialize_distributed(
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    backend: str | None = None,
) -> None:
    """torch.distributed.init_process_group with an explicit topology
    (init_method such as "tcp://localhost:29500", the world size and this
    process's rank); backend defaults to NCCL where a card is visible, else
    gloo. No-op when already initialized or when no init_method is given
    (one process)."""
    if dist.is_initialized() or init_method is None:
        return
    if world_size is None or rank is None:
        raise ValueError("initialize_distributed needs world_size and rank with init_method")
    dist.init_process_group(backend or ("nccl" if torch.cuda.is_available() else "gloo"),
                            init_method=init_method, world_size=world_size, rank=rank)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def global_mesh_shards(shards_per_process: int = 1) -> int:
    """Shards of a whole-job encode: shards_per_process in every process."""
    return process_count() * shards_per_process


def is_coordinator() -> bool:
    return process_index() == 0


def _distributed_geometry(height: int, width: int, config: EncoderConfig):
    """(sharding.Geometry, shards per process)."""
    from .sharding import Geometry

    n, n_proc = config.num_shards, process_count()
    if n % n_proc:
        raise ValueError(f"num_shards={n} must be divisible by process_count={n_proc}")
    return Geometry.of(height, width, config.chroma_subsampling, n), n // n_proc


def local_row_range(height: int, width: int, config: EncoderConfig) -> tuple[int, int]:
    """Rows [r0, r1) of the ORIGINAL image this process must supply to
    encode_array_distributed. r1 is clamped to the image height: rows
    beyond it are padding this process makes itself (black, as the
    reference's padder, padder.rs:16), so a process whose shards are all
    alignment padding loads nothing."""
    geom, spp = _distributed_geometry(height, width, config)
    pid = process_index()
    return min(pid * spp * geom.shard_h, height), min((pid + 1) * spp * geom.shard_h, height)


def _all_gather(t: torch.Tensor, comm: torch.device) -> list[torch.Tensor]:
    """all_gather of equal-shape tensors through the group's device `comm`
    (the CPU for gloo); one process: [t]."""
    if not dist.is_initialized():
        return [t]
    x = t.to(comm).contiguous()
    out = [torch.empty_like(x) for _ in range(process_count())]
    dist.all_gather(out, x)
    return out


def encode_array_distributed(
    local_pixels: np.ndarray | None,
    height: int,
    width: int,
    maxval: int,
    config: EncoderConfig,
    device="cuda",
) -> bytes | None:
    """Multi-process encode from process-local image rows.

    local_pixels: this process's rows of the original image (see
    local_row_range), [r1 - r0, width, 3] uint8/uint16, or None when the
    range is empty. `device`: this process's shard devices
    (sharding.shard_devices of num_shards / process_count()). Every process
    must call this with the same image geometry and config; process 0
    returns the JPEG bytes, every other process None. Runs the one-dispatch
    sharded encode only, as the JAX package does (one_dispatch is not
    read); NotImplementedError where that does not apply
    (DMMT_NO_FUSED_PACK, an image past the device table build's bound)."""
    from ..bitstream.device_pack import check_scan_bits
    from ..encoder import _jpeg
    from ..huffman.tables import split_histograms, tables_from_spec
    from .sharding import (
        chain_dc,
        device_tables,
        gather_histograms,
        last_dcs,
        merge_and_stuff,
        onedispatch_allowed,
        pack_shard,
        raw_blocks,
        shard_devices,
        shard_histograms,
    )

    if not onedispatch_allowed(config, height, width):
        raise NotImplementedError("the multi-process encode runs the one-dispatch sharded "
                                  "encode only (DMMT_NO_FUSED_PACK, image size)")
    geom, spp = _distributed_geometry(height, width, config)
    devices = shard_devices(device, spp)
    pid = process_index()
    comm = devices[0] if dist.is_initialized() and dist.get_backend() == "nccl" \
        else torch.device("cpu")
    luma_q, chroma_q = quantization_table_pair(config.quantization_preset, config.quality)

    # this process's slab of the global padded image: its rows, black around
    sh = geom.shard_h
    slab = np.zeros((spp * sh, geom.pw, 3), np.uint8 if maxval <= 255 else np.uint16)
    if local_pixels is not None and len(local_pixels):
        lp = narrow_pixels(np.asarray(local_pixels), maxval)
        slab[: lp.shape[0], : lp.shape[1]] = lp
    slabs = [as_device(slab[j * sh: (j + 1) * sh], maxval, dev) for j, dev in enumerate(devices)]
    raw = raw_blocks(slabs, maxval, config, luma_q, chroma_q, devices)
    lasts = _all_gather(last_dcs(raw[-1], 1), comm)
    blocks = chain_dc(raw, 1, devices, first=lasts[pid - 1] if pid else None)
    shards = [pid * spp + j for j in range(spp)]
    hists = gather_histograms([shard_histograms(x, 1, geom, s, dev)
                               for s, x, dev in zip(shards, blocks, devices)], devices[0]).sum(dim=0)
    if dist.is_initialized():
        summed = hists.to(comm)
        dist.all_reduce(summed)
        hists = summed.to(devices[0])
    with on_device(devices[0]):
        tables = device_tables(hists)
    codes, lens = (tables[k].reshape(1, 4, 256) for k in ("codes_flat", "lens_flat"))
    words, bits = [], []
    for s, x, dev in zip(shards, blocks, devices):
        w, b = pack_shard(x, 1, geom, s, dev, codes.to(dev), lens.to(dev), onepack=False)
        words.append(w[0])
        bits.append(b.to(devices[0]))
    all_bits = torch.cat(_all_gather(torch.cat(bits), comm)).cpu().numpy()  # [n] in shard order
    needed = (all_bits + 31) // 32
    longest = int(needed.max())
    local = torch.zeros((spp, longest), dtype=torch.int32, device=devices[0])
    for j, w in enumerate(words):
        local[j, : int(needed[shards[j]])] = w[: int(needed[shards[j]])].to(devices[0])
    segments = torch.cat(_all_gather(local, comm)).cpu().numpy()  # [n, longest]
    if pid != 0:
        return None
    table = tables_from_spec(*(tables[k].cpu().numpy() for k in ("sym_by_leaf", "len_by_leaf",
                                                                 "n_present")))
    check_scan_bits(all_bits.sum(), (split_histograms(hists[0]), table), "distributed encode")
    scan = merge_and_stuff([(segments[s, : needed[s]].view(np.uint8), int(all_bits[s]))
                            for s in range(config.num_shards)])
    return _jpeg((height, width), config, luma_q, chroma_q, scan, table)


def scaling_report(mpix_per_s_one_chip: float, mpix_per_s_n_chips: float,
                   n_chips: int) -> dict:
    """Scaling-efficiency summary: throughput on n chips against n times one
    chip's."""
    ideal = mpix_per_s_one_chip * n_chips
    eff = mpix_per_s_n_chips / ideal if ideal else 0.0
    return {
        "chips": n_chips,
        "throughput_mpix_s": round(mpix_per_s_n_chips, 2),
        "ideal_mpix_s": round(ideal, 2),
        "scaling_efficiency": round(eff, 4),
    }
