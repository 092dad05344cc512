"""Build, load and launch-count the port's hand-written CUDA kernels.

All sources in ../csrc/*.cu compile with nvcc into ONE shared library
with a plain C interface, loaded with ctypes: one nvcc per source, all
started together, then one link. The build happens at first use (never at
import), into the repository's `build/kernels/` directory (listed in
.gitignore), keyed by a hash of the sources and flags, so a fresh
checkout rebuilds in seconds and an unchanged one reuses the library. A
failed build raises.

Flags: sm_90a (Hopper), `--fmad=false` (no FMA contraction: the phase-1
chain must round after every multiply and add to stay bit-exact with the
JAX reference) and `-prec-div=true` (IEEE division); never
`--use_fast_math`.

Every C entry point takes PyTorch's current stream and returns
`cudaGetLastError()` after its launches; `check` raises on a nonzero
code. Each kernel wrapper adds one to its count in `LAUNCHES` where it
launches its kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH, "-std=c++17", "-O3", "--fmad=false", "-prec-div=true", "-Xcompiler", "-fPIC",
)

# kernel name -> launches since the last reset_launch_counts()
LAUNCHES: dict[str, int] = {"phase1": 0, "block_hist": 0, "scan_pack": 0, "scan_pack_slab": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# C entry point -> argtypes (every pointer and the stream as c_void_p)
_SIGNATURES = {
    "dmmt_phase1": (_P, _I, _I, _I, _I, _I, ctypes.c_float, _P, _P, _P, _P, _P, _P, _P),
    "dmmt_block_hist": (_P, _LL, _LL, _P, _P, _P),
    "dmmt_scan_pack": (_P, _LL, _I, _I, _P, _P, _P, _P, _P, _P, _LL, _P, _P),
    "dmmt_scan_pack_slab": (_P, _I, _LL, _I, _I, _P, _P, _P, _P, _P, _P, _LL, _P, _P),
}

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home:
        return str(Path(cuda_home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def compile_command(src: Path, obj: Path) -> list[str]:
    """The exact nvcc command line that compiles one source."""
    return [nvcc_path(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]


def link_command(objs: list[Path], out: Path) -> list[str]:
    """The nvcc command line that links the objects into the library."""
    return [nvcc_path(), *ARCH, "-shared", "-o", str(out), *(str(o) for o in objs)]


def _build(out: Path) -> None:
    """Compile every source in parallel, then link; raise on any failure."""
    tmp = BUILD_DIR / f"{out.stem}.{os.getpid()}.tmp"
    tmp.mkdir(parents=True, exist_ok=True)
    objs = [tmp / f"{s.stem}.o" for s in sources()]
    procs = [
        (s, subprocess.Popen(compile_command(s, o), stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True))
        for s, o in zip(sources(), objs)
    ]
    failed = []
    for s, p in procs:
        _, err = p.communicate()
        if p.returncode != 0:
            failed.append(f"{s.name} ({p.returncode}):\n{err}")
    if failed:
        raise RuntimeError("nvcc failed building " + out.name + ":\n" + "\n".join(failed))
    lib = tmp / out.name
    proc = subprocess.run(link_command(objs, lib), capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}) for {out.name}:\n{proc.stderr}")
    os.replace(lib, out)
    shutil.rmtree(tmp, ignore_errors=True)


def library_path() -> Path:
    srcs = sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return BUILD_DIR / f"dmmt_kernels_{h.hexdigest()[:16]}.so"


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; raises on failure."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        out = library_path()
        if not out.exists():
            _build(out)
        lib = ctypes.CDLL(str(out))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _LIB = lib
        return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA error {err} launching {what}")


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)
