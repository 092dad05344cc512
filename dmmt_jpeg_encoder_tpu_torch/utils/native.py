"""Build-and-load for the native C host helpers.

The C sources are the port's own `csrc/ppm_parse.c` (the PPM parser) and
`csrc/scan_encoder.c` (the host scan packer, bitstream/packer.py), copies
of the JAX package's `bitstream/csrc/` files: the port reads no file of
the JAX package; and `csrc/host_copy.c`, the host copy of the upload
ring (programs._Ring, through `copy_pool`). They are compiled together
once on first use with `cc` into one library in the repository's
`build/native/` directory (listed in .gitignore), keyed by a hash of the
sources and flags. They are built
without -march=native, so a build directory copied to another machine
still loads. The pure-Python tokenizer in io/ppm.py and the Python packer
in bitstream/packer.py, and numpy's copy for the ring, stay as the
fallbacks when no C toolchain is present.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sysconfig
import threading
from pathlib import Path
from typing import Callable

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
PPM_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "ppm_parse.c"
SCAN_SOURCE = PPM_SOURCE.with_name("scan_encoder.c")
COPY_SOURCE = PPM_SOURCE.with_name("host_copy.c")
SOURCES = (PPM_SOURCE, SCAN_SOURCE, COPY_SOURCE)
BUILD_DIR = _REPO / "build" / "native"
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_LIB_FAILED = False


def _command(out: Path) -> list[str]:
    cc = os.environ.get("CC", "cc")
    return [
        cc, "-O3", "-shared", "-fPIC", "-std=c11", "-pthread",
        "-o", str(out), *(str(s) for s in SOURCES),
    ]


def load_native() -> ctypes.CDLL | None:
    """Return the native helper library, building it if needed; None if a
    source is missing or building fails (callers fall back to Python)."""
    global _LIB, _LIB_FAILED
    if _LIB is not None or _LIB_FAILED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _LIB_FAILED:
            return _LIB
        if os.environ.get("DMMT_JPEG_TPU_NO_NATIVE") or not all(s.is_file() for s in SOURCES):
            _LIB_FAILED = True
            return None
        key = b"".join(s.read_bytes() for s in SOURCES) + " ".join(_command(Path())).encode()
        digest = hashlib.sha256(key).hexdigest()[:16]
        suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
        out = BUILD_DIR / f"dmmt_native_{digest}{suffix}"
        try:
            if not out.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
                subprocess.run(_command(tmp), check=True, capture_output=True)
                os.replace(tmp, out)
            _LIB = ctypes.CDLL(str(out))
        except (OSError, subprocess.CalledProcessError):
            _LIB_FAILED = True
            return None
        return _LIB


def copy_pool(workers: int,
              bytes_per_helper: int) -> Callable[[np.ndarray, np.ndarray], None] | None:
    """copy(dst, src) for two C-contiguous host arrays of the same bytes,
    made by the calling thread and, for each whole `bytes_per_helper` of
    them, one of `workers` native threads started here and kept for the
    life of the process (csrc/host_copy.c); ctypes releases the
    interpreter's lock for the call. None where the native library is not
    built. One caller at a time per pool."""
    lib = load_native()
    if lib is None:
        return None
    lib.dmmt_copy_pool_new.argtypes = [ctypes.c_int]
    lib.dmmt_copy_pool_new.restype = ctypes.c_void_p
    lib.dmmt_copy_pool_run.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_long, ctypes.c_int]
    lib.dmmt_copy_pool_run.restype = None
    pool = lib.dmmt_copy_pool_new(workers)
    if not pool:
        return None
    run = lib.dmmt_copy_pool_run

    def copy(dst: np.ndarray, src: np.ndarray) -> None:
        if dst.nbytes != src.nbytes or not (dst.flags.c_contiguous and src.flags.c_contiguous):
            raise ValueError("copy_pool copies between C-contiguous arrays of equal bytes")
        run(pool, dst.ctypes.data, src.ctypes.data, src.nbytes,
            min(workers, src.nbytes // bytes_per_helper))

    return copy
