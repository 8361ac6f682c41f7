"""Build and load the port's hand-written CUDA kernels.

``csrc/flash_fwd.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes``. It is built at first use into
``_build/`` beside this file, named by a hash of its source and flags, so
an edited source rebuilds and an unchanged one loads at once.

Nothing here runs at import time: the CPU tests import every module, on
hosts that may have neither ``nvcc`` nor a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_fwd.cu"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# rt_flash_fwd's arguments (ctypes cuts an undeclared pointer to 32 bits):
# q, k, v, out, lse pointers; dtype, b, h, hk, sq, skv, d; the batch,
# sequence and head strides of q, k, v and out; scale, causal, stream
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
FLASH_FWD_ARGTYPES = ([_P] * 5 + [_I] * 7 + [_LL] * 12
                      + [ctypes.c_float, _I, _P])

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    conventional install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the CUDA kernels")


def lib_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libflash_fwd-{digest[:16]}.so"


def build() -> Path:
    """Compile the library unless it is built already, and return its
    path. Raises with the compiler's output if the build fails. The
    ``-Xptxas -v`` report (registers, shared memory, spills) is kept in
    ``<lib>.log``."""
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                          str(SOURCE)], capture_output=True, text=True)
    log = res.stdout + res.stderr
    out.with_suffix(".log").write_text(log)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCE.name}:\n{log}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.rt_flash_fwd.argtypes = FLASH_FWD_ARGTYPES
            lib.rt_flash_fwd.restype = _I
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what} failed with CUDA error {err}")
