"""PyTorch port, the multi-process encode (parallel/multihost.py): two
real torch.distributed processes (gloo, on the CPU, with jax made
unimportable) against the JAX package's single-device encode_array, byte
for byte, plus the single-process form and the wiring helpers."""

import dataclasses
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import dmmt_jpeg_encoder_tpu as dj
import dmmt_jpeg_encoder_tpu_torch as dt
from dmmt_jpeg_encoder_tpu.parallel import multihost as jmh
from dmmt_jpeg_encoder_tpu_torch import onedispatch as tod
from dmmt_jpeg_encoder_tpu_torch.parallel import multihost as mh

REPO = Path(__file__).resolve().parent.parent

# (height, width, num_shards) under PRESETS: P420, 7 MCU rows over 4 shards
# (2 per process); P422, 5 MCU rows over 4 shards, so process 1's last
# shard is all padding; P444, one MCU row over 2 shards, so process 1 has
# no row to load
CASES = [(100, 40, 4), (40, 72, 4), (8, 24, 2)]

WORKER = r"""
import sys
sys.modules["jax"] = None
sys.path.insert(0, sys.argv[5])
import numpy as np
import dmmt_jpeg_encoder_tpu_torch as dt
from dmmt_jpeg_encoder_tpu_torch.parallel import multihost as mh

rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
mh.initialize_distributed(f"tcp://127.0.0.1:{port}", world, rank, backend="gloo")
assert mh.process_index() == rank and mh.process_count() == world
assert mh.is_coordinator() == (rank == 0)
for k, (h, w, n) in enumerate(CASES):
    px = np.random.default_rng(k).integers(0, 256, (h, w, 3)).astype(np.uint8)
    cfg = dt.EncoderConfig(chroma_subsampling=dt.ChromaSubsamplingPreset(PRESETS[k]),
                           num_shards=n)
    r0, r1 = mh.local_row_range(h, w, cfg)
    jpeg = mh.encode_array_distributed(px[r0:r1] if r1 > r0 else None, h, w, 255, cfg,
                                       device=["cpu"] * (n // world))
    if rank == 0:
        open(f"{out}.{k}", "wb").write(jpeg)
    else:
        assert jpeg is None
bad = [m for m in sys.modules if m.startswith(("jax.", "dmmt_jpeg_encoder_tpu."))
       or m in ("jaxlib", "dmmt_jpeg_encoder_tpu")]
assert not bad, bad
"""
PRESETS = ["P420", "P422", "P444"]


def _pixels(k, h, w):
    return np.random.default_rng(k).integers(0, 256, (h, w, 3)).astype(np.uint8)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_distributed_encode_matches_jax(tmp_path):
    code = f"CASES = {CASES!r}\nPRESETS = {PRESETS!r}\n" + WORKER
    port = _free_port()
    # the loopback address and interface, so that neither c10d's store nor
    # gloo's device looks up a host name
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["GLOO_SOCKET_IFNAME"] = "lo"
    procs = [subprocess.Popen([sys.executable, "-c", code, str(rank), "2", str(port),
                               str(tmp_path / "jpeg"), str(REPO)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for rank in range(2)]
    try:
        results = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, (_, err) in zip(procs, results):
        assert p.returncode == 0, err
    for k, (h, w, n) in enumerate(CASES):
        cfg = dj.EncoderConfig(chroma_subsampling=dj.ChromaSubsamplingPreset(PRESETS[k]))
        assert (tmp_path / f"jpeg.{k}").read_bytes() == dj.encode_array(_pixels(k, h, w), 255, cfg)


def test_local_row_ranges():
    """One process: every row; the geometry follows sharding.shard_geometry."""
    cfg = dt.EncoderConfig(num_shards=4)
    assert mh.local_row_range(100, 40, cfg) == (0, 100)
    assert mh.global_mesh_shards() == 1 and mh.global_mesh_shards(4) == 4
    assert mh.process_count() == 1 and mh.process_index() == 0 and mh.is_coordinator()


def test_encode_array_distributed_single_process(monkeypatch):
    """one_dispatch="off" is not read, as in the JAX package: the same
    bytes; DMMT_NO_FUSED_PACK and an image past the device table bound
    raise, where the JAX package raises."""
    px = _pixels(3, 57, 33)
    cfg = dt.EncoderConfig(chroma_subsampling=dt.ChromaSubsamplingPreset.P422, num_shards=3)
    want = dj.encode_array(px, 255, dj.EncoderConfig(chroma_subsampling=dj.ChromaSubsamplingPreset.P422))
    assert mh.encode_array_distributed(px, 57, 33, 255, cfg, device="cpu") == want
    off = dataclasses.replace(cfg, one_dispatch="off")
    assert mh.encode_array_distributed(px, 57, 33, 255, off, device="cpu") == want
    monkeypatch.setenv("DMMT_NO_FUSED_PACK", "1")
    with pytest.raises(NotImplementedError):
        mh.encode_array_distributed(px, 57, 33, 255, cfg, device="cpu")
    monkeypatch.delenv("DMMT_NO_FUSED_PACK")
    monkeypatch.setattr(tod, "MAX_DEVICE_TABLE_SYMBOLS", 64 * 10)
    with pytest.raises(NotImplementedError):
        mh.encode_array_distributed(px, 57, 33, 255, cfg, device="cpu")


def test_initialize_is_noop_without_init_method():
    mh.initialize_distributed()
    assert mh.process_count() == 1
    with pytest.raises(ValueError):
        mh.initialize_distributed("tcp://localhost:1")


def test_scaling_report_matches_jax():
    for args in ((100.0, 380.0, 4), (50.0, 95.5, 2), (10.0, 0.0, 8), (0.0, 5.0, 2)):
        assert mh.scaling_report(*args) == jmh.scaling_report(*args)
