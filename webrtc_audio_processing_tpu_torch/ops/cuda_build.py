"""Builds the package's CUDA kernels and loads them with ctypes.

The sources in ``csrc/`` have a plain C interface, so ``nvcc`` compiles them
in seconds into one shared library, without PyTorch's headers: one ``nvcc``
per source, all started together, then one link. The build
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

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("biquad.cu", "window.cu", "span.cu", "matched_filter.cu",
           "pre_echo.cu", "subtractor.cu", "agc1_limiter.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # x, y, state_in, state_out, coeffs, K, T, M, allpass, stream
    "biquad_cascade_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # buf, start, start_bytes, out, B, L, W, stream
    "take_windows_f32": (_P, _P, _I, _P, _I, _I, _I, _P),
    # ring, start, out, B, LP, F, W, stream
    "span_gather_f32": (_P, _P, _P, _I, _I, _I, _I, _P),
    # the same for a bfloat16 ring, written as float32
    "span_gather_bf16": (_P, _P, _P, _I, _I, _I, _I, _P),
    # lowrate, lr_read, h0, y, smoothing, h, alphas, err, updated, segs,
    # B, N, shift, ds_size, threshold, sub, taps, stream
    "matched_filter_nlms_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, ctypes.c_float, _I, _I, _P),
    # seg, h0, alphas, y, out, B, sub, taps, acc_rate, stream
    "pre_echo_inst_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # 13 inputs, 13 outputs, B, C, P, Pc, R, W2, F, nb, the host-side
    # float and int constants, stream
    "subtractor_pair_f32": (_P,) * 26 + (_I,) * 8 + (
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int), _P),
    # gains_in, env, gains_out, N, stream
    "agc1_limiter_i32": (_P, _P, _P, _I, _P),
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


def _run(cmds):
    """Run the commands in parallel; raise on the first that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    for c, p, out in zip(cmds, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({p.returncode}):\n{' '.join(c)}\n{out}")
    return "".join(logs)


def _build(so_path: Path):
    """Compile every source to an object at once, then link the library
    under a temporary name and move it into place. Returns (seconds,
    log)."""
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / (n + ".o")) for n in SOURCES]
        log = _run([[nvcc, *NVCC_FLAGS, "-c", str(CSRC / n), "-o", o]
                    for n, o in zip(SOURCES, objs)])
        out = str(Path(tmp) / so_path.name)
        log += _run([[nvcc, "-shared", "-Wno-deprecated-gpu-targets", "-o", out,
                     *objs]])
        os.replace(out, so_path)
    return time.perf_counter() - t0, log


def library() -> KernelLibrary:
    """Build (if needed) and load the kernel library; cached per process."""
    global _LIBRARY
    if _LIBRARY is not None:
        return _LIBRARY
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so_path = BUILD_DIR / f"libwap_kernels_{_digest()}.so"
    seconds, log = 0.0, ""
    if not so_path.exists():
        seconds, log = _build(so_path)
    lib = ctypes.CDLL(str(so_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    _LIBRARY = KernelLibrary(lib, so_path, seconds, log)
    return _LIBRARY


def ptxas_lines(log: str) -> list[str]:
    """The ``-Xptxas -v`` lines of a build's log that name each kernel and
    give its registers and spills (none when the library was reused)."""
    return [ln.strip() for ln in log.splitlines()
            if "entry function" in ln or "registers" in ln or "spill" in ln]


def check_current_device(t) -> None:
    """Raise ValueError unless ``t`` lies on the current CUDA device. A
    kernel launches in the current device's context, on the stream
    ``raw_stream`` hands it: a tensor of another card (a shard on cuda:1
    while cuda:0 is current) would be launched against the wrong context.
    Launch under ``torch.cuda.device(t.device)``."""
    dev = t.device
    if dev.type != "cuda":
        raise ValueError(f"a kernel launch needs a CUDA tensor, got one on "
                         f"{dev}")
    current = torch.cuda.current_device()
    if dev.index != current:
        raise ValueError(
            f"the tensor is on {dev} but the current CUDA device is "
            f"cuda:{current}; launch under torch.cuda.device({dev})")


def raw_stream(t) -> int:
    """The handle of PyTorch's current CUDA stream on ``t``'s device, read
    without building a ``torch.cuda.Stream`` object; ``t`` must lie on the
    current device (``check_current_device``)."""
    check_current_device(t)
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def check(err: int, name: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name} failed with CUDA error {err}")
