"""Kernel capability probe, and the mode key of captured programs.

Counterpart of dmmt_jpeg_encoder_tpu.utils.capability (`pallas_capable`,
`_probe_lowering`). The JAX package lowered a trivial pallas_call once per
process and, where that failed, wrote a line to stderr and fell back to
XLA paths. Here `kernels_capable(device)` answers per device:

- the CPU: False. The sharded encode then takes the paths the JAX package
  takes without Pallas (masked histograms, two dispatches, the staged
  pack), each kernel wrapper running its plain version;
- a CUDA device: the probe kernel (csrc/probe.cu, `probe_add_one`) is
  launched once per process and device on an [8, 128] float32 tile and its
  result checked against x + 1; True once it has passed. A failed build,
  launch or check raises: the port never hides the card behind a fallback.

`trace_mode_key()` and `mode_keyed_cache(maxsize)` are the counterparts of
the JAX package's: every cache of captured programs (CUDA graphs, run by
programs.py) keys on the environment modes baked into a capture, so that
a mode toggled after the first capture at a geometry takes effect. The
key holds every knob that those enqueues read (DMMT_P1, DMMT_HIST,
DMMT_P1_PREC, DMMT_SLAB_ONEPACK, and DMMT_NO_FUSED_PACK, which picks the
two-dispatch packs' route and which neither package's one-dispatch
program reads). The JAX key's other entries have no
counterpart: DMMT_FUSED1_TILEW (the TPU kernel's tile width; K10's tiling
is fixed), DMMT_PALLAS_INTERPRET and pallas_capable() (a graph is
captured only on a card, whose kernels always run; the CPU runs the plain
versions eagerly), DMMT_TABLE_ABLATE (a TPU timing ablation the port
does not carry) and DMMT_SWEEP / DMMT_SWEEP_HEAD (the TPU pack's table
sweep; K3 holds the whole tables in shared memory). DMMT_FORCE_PALLAS has
no counterpart either: a card's probe failure raises.
"""

from __future__ import annotations

import functools
import os
from functools import lru_cache

import torch

from ..kernels import build

PROBE_SHAPE = (8, 128)

# CUDA device indices whose probe passed in this process
_CAPABLE: set[int] = set()


def trace_mode_key() -> tuple:
    """Everything from the environment that is baked into a captured
    program (the module docstring lists it). Any cache that holds such a
    program keys on this (mode_keyed_cache)."""
    return (
        os.environ.get("DMMT_P1", "plane"),
        os.environ.get("DMMT_HIST", "fused"),
        os.environ.get("DMMT_P1_PREC", "highest"),
        os.environ.get("DMMT_SLAB_ONEPACK", "0"),
        bool(os.environ.get("DMMT_NO_FUSED_PACK")),
    )


def mode_keyed_cache(maxsize: int):
    """`lru_cache` whose key silently includes trace_mode_key(): decorate a
    program cache once, so that no cache can forget the modes."""

    def deco(fn):
        @lru_cache(maxsize=maxsize)
        def keyed(_mode, *args, **kw):
            return fn(*args, **kw)

        @functools.wraps(fn)
        def wrapper(*args, **kw):
            return keyed(trace_mode_key(), *args, **kw)

        wrapper.cache_clear = keyed.cache_clear
        wrapper.cache_info = keyed.cache_info
        return wrapper

    return deco


def probe_add_one(x: torch.Tensor) -> torch.Tensor:
    """x + 1 on a float32 tensor: the probe kernel, or on a CPU tensor its
    plain version."""
    if x.dtype != torch.float32:
        raise ValueError(f"expected float32, got {x.dtype}")
    if x.device.type == "cpu":
        return x + 1
    if x.device.type != "cuda":
        raise ValueError(f"probe kernel needs a CUDA tensor, got {x.device}")
    x = x.contiguous()
    out = torch.empty_like(x)
    lib = build.load()
    err = lib.dmmt_probe(x.data_ptr(), out.data_ptr(), x.numel(),
                         torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "dmmt_probe")
    build.LAUNCHES["probe"] += 1
    return out


def kernels_capable(device: torch.device | str) -> bool:
    """True for a CUDA device whose probe kernel ran and gave x + 1 (probed
    once per process and device), False for the CPU; raises for a CUDA
    device where the build, the launch or the result fails."""
    device = torch.device(device)
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"no kernels for device type {device.type!r}")
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index in _CAPABLE:
        return True
    dev = torch.device("cuda", index)
    x = torch.arange(PROBE_SHAPE[0] * PROBE_SHAPE[1], dtype=torch.float32,
                     device=dev).reshape(PROBE_SHAPE)
    with torch.cuda.device(dev):
        out = probe_add_one(x)
    if not torch.equal(out, x + 1):
        raise RuntimeError(f"the probe kernel gave a wrong result on {dev}")
    _CAPABLE.add(index)
    return True
