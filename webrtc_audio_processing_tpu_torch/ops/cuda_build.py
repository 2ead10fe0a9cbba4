"""Builds the package's CUDA kernels and loads them with ctypes.

The sources in ``csrc/`` have a plain C interface, so ``nvcc`` compiles them
in seconds into one shared library, without PyTorch's headers. The build
runs at first use, into ``_build/`` beside this package (listed in
``.gitignore``), under a name keyed by a hash of the sources and flags: a
changed source builds anew, an unchanged one loads the library it finds.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("biquad.cu", "window.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # x, y, state_in, state_out, coeffs, K, T, M, stream
    "biquad_cascade_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    # buf, start, out, B, L, W, stream
    "take_windows_f32": (_P, _P, _P, _I, _I, _I, _P),
}


class KernelLibrary:
    """The loaded shared library and what its build reported."""

    def __init__(self, lib: ctypes.CDLL, path: Path, seconds: float,
                 log: str):
        self.lib = lib
        self.path = path
        self.build_seconds = seconds  # 0.0 when a built library was reused
        self.log = log  # nvcc's output, including -Xptxas -v


_LIBRARY: KernelLibrary | None = None


def _nvcc() -> str:
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build only where the CUDA "
            "toolkit is installed"
        )
    return found


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library() -> KernelLibrary:
    """Build (if needed) and load the kernel library; cached per process."""
    global _LIBRARY
    if _LIBRARY is not None:
        return _LIBRARY
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so_path = BUILD_DIR / f"libwap_kernels_{_digest()}.so"
    seconds, log = 0.0, ""
    if not so_path.exists():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               *(str(CSRC / n) for n in SOURCES)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}"
            )
        os.replace(tmp, so_path)
    lib = ctypes.CDLL(str(so_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    _LIBRARY = KernelLibrary(lib, so_path, seconds, log)
    return _LIBRARY


def check(err: int, name: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name} failed with CUDA error {err}")
