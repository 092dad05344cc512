"""Build-and-load for the native C PPM parser.

The C source is the port's own `csrc/ppm_parse.c`, a copy of the JAX
package's `bitstream/csrc/ppm_parse.c`: the port reads no file of the JAX
package. It is compiled once on first use with `cc` into the
repository's `build/native/` directory (listed in .gitignore), keyed by a
hash of the source and flags. It is built without -march=native, so a
build directory copied to another machine still loads. The pure-Python
tokenizer in io/ppm.py stays as the fallback when no C toolchain is
present.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sysconfig
import threading
from pathlib import Path

_REPO = Path(__file__).resolve().parents[2]
PPM_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "ppm_parse.c"
BUILD_DIR = _REPO / "build" / "native"
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_LIB_FAILED = False


def _command(source: Path, out: Path) -> list[str]:
    cc = os.environ.get("CC", "cc")
    return [
        cc, "-O3", "-shared", "-fPIC", "-std=c11", "-pthread",
        "-o", str(out), str(source),
    ]


def load_native() -> ctypes.CDLL | None:
    """Return the native PPM parser library, building it if needed; None if
    the source is missing or building fails (callers fall back to Python)."""
    global _LIB, _LIB_FAILED
    if _LIB is not None or _LIB_FAILED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _LIB_FAILED:
            return _LIB
        if os.environ.get("DMMT_JPEG_TPU_NO_NATIVE") or not PPM_SOURCE.is_file():
            _LIB_FAILED = True
            return None
        key = PPM_SOURCE.read_bytes() + " ".join(_command(PPM_SOURCE, Path())).encode()
        digest = hashlib.sha256(key).hexdigest()[:16]
        suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
        out = BUILD_DIR / f"ppm_parse_{digest}{suffix}"
        try:
            if not out.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
                subprocess.run(_command(PPM_SOURCE, tmp), check=True, capture_output=True)
                os.replace(tmp, out)
            _LIB = ctypes.CDLL(str(out))
        except (OSError, subprocess.CalledProcessError):
            _LIB_FAILED = True
            return None
        return _LIB
