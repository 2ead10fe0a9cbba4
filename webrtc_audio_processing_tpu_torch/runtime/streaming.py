"""ctypes bindings for the native streaming plane and the batching engine.

The port's own copy of ``webrtc_audio_processing_tpu/runtime/streaming.py``.
The C++ plane (``native/streaming_plane.cc``, framework-free) owns the
lock-free per-stream frame queues (the reference's SwapQueue hand-off,
rtc_base/swap_queue.h), race checking (rtc_base/race_checker.h) and the
drop and throughput counters. It is built with g++ at first use into the
package's ``_build/`` (listed in ``.gitignore``) under a name keyed by a
hash of the source, so an unchanged source loads the library it finds.

``BatchEngine.step()`` collects one 10 ms frame per ready stream into host
batches (numpy views of pinned tensors when the step runs on the card),
runs the batched device step, copies its output back into a host buffer of
its own and scatters it through the plane's output queues.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from webrtc_audio_processing_tpu_torch.ops.cuda_build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[2] / "native" / "streaming_plane.cc"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

_LIB_LOCK = threading.Lock()
_LIB = None


def library_path() -> Path:
    """Where the plane's library lives: ``_build/`` keyed by a hash of the
    source and the flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libwap_streaming_plane_{h.hexdigest()[:16]}.so"


def _build_library() -> Path:
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = Path(tmp) / so.name
        proc = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(out)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}) building "
                               f"{SOURCE}:\n{proc.stderr}")
        os.replace(out, so)
    return so


def _load():
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(_build_library()))
        FP = ctypes.POINTER(ctypes.c_float)
        U8P = ctypes.POINTER(ctypes.c_uint8)
        lib.wap_plane_create.restype = ctypes.c_void_p
        lib.wap_plane_create.argtypes = [ctypes.c_int] * 5
        lib.wap_plane_destroy.argtypes = [ctypes.c_void_p]
        lib.wap_push_capture.restype = ctypes.c_int
        lib.wap_push_capture.argtypes = [ctypes.c_void_p, ctypes.c_int, FP]
        lib.wap_push_render.restype = ctypes.c_int
        lib.wap_push_render.argtypes = [ctypes.c_void_p, ctypes.c_int, FP]
        lib.wap_collect_batch.restype = ctypes.c_int
        lib.wap_collect_batch.argtypes = [ctypes.c_void_p, FP, FP, U8P]
        lib.wap_distribute_batch.argtypes = [ctypes.c_void_p, FP, U8P]
        lib.wap_pop_output.restype = ctypes.c_int
        lib.wap_pop_output.argtypes = [ctypes.c_void_p, ctypes.c_int, FP]
        for name in ("wap_stream_races", "wap_stream_dropped",
                     "wap_stream_frames_processed"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_long
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.wap_capture_queue_size.restype = ctypes.c_int
        lib.wap_capture_queue_size.argtypes = [ctypes.c_void_p, ctypes.c_int]
        _LIB = lib
        return lib


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class StreamingPlane:
    """Python handle over the native per-stream queue plane."""

    def __init__(self, num_streams: int, samples: int,
                 capture_channels: int = 1, render_channels: int = 1,
                 queue_capacity: int = 16):
        self._lib = _load()
        self._handle = self._lib.wap_plane_create(
            num_streams, samples, capture_channels, render_channels,
            queue_capacity)
        if not self._handle:
            raise ValueError("invalid streaming plane geometry")
        self.num_streams = num_streams
        self.samples = samples
        self.capture_channels = capture_channels
        self.render_channels = render_channels

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.wap_plane_destroy(self._handle)
            self._handle = None

    def push_capture(self, stream: int, frame: np.ndarray) -> bool:
        f = np.ascontiguousarray(frame, np.float32)
        assert f.size == self.samples * self.capture_channels
        return bool(self._lib.wap_push_capture(self._handle, stream, _fp(f)))

    def push_render(self, stream: int, frame: np.ndarray) -> bool:
        f = np.ascontiguousarray(frame, np.float32)
        assert f.size == self.samples * self.render_channels
        return bool(self._lib.wap_push_render(self._handle, stream, _fp(f)))

    def collect_batch(self, capture_out, render_out, ready_mask) -> int:
        return self._lib.wap_collect_batch(
            self._handle, _fp(capture_out), _fp(render_out), _u8p(ready_mask))

    def distribute_batch(self, batch, ready_mask) -> None:
        self._lib.wap_distribute_batch(self._handle, _fp(batch),
                                       _u8p(ready_mask))

    def pop_output(self, stream: int):
        out = np.empty((self.samples, self.capture_channels), np.float32)
        ok = self._lib.wap_pop_output(self._handle, stream, _fp(out))
        return out if ok else None

    # ------------------------------------------------ metrics / debug

    def races(self, stream: int) -> int:
        return int(self._lib.wap_stream_races(self._handle, stream))

    def dropped(self, stream: int) -> int:
        return int(self._lib.wap_stream_dropped(self._handle, stream))

    def frames_processed(self, stream: int) -> int:
        return int(self._lib.wap_stream_frames_processed(self._handle,
                                                         stream))

    def capture_queue_size(self, stream: int) -> int:
        return int(self._lib.wap_capture_queue_size(self._handle, stream))


class BatchEngine:
    """Batches N independent streams through one device step.

    ``step_fn(state, capture (N, S, Cc), render (N, S, Cr)) -> (state,
    out)``: the inputs are tensors on ``device`` (the engine copies the
    pinned host batches there), ``out`` an (N, S, Cc) float32 tensor the
    step may own and overwrite on its next call. The per-stream states
    live on ``device``; frames move through the plane's queues.
    """

    def __init__(self, plane: StreamingPlane, step_fn, state,
                 flush_every: int = 1, device=None, sync_stages=False):
        """``flush_every``: hand outputs to the plane every N steps; each
        pending output has a host buffer of its own. ``sync_stages``: wait
        for the device after each stage, so that ``seconds`` splits the
        step into its stages (collect, H2D copy and step, D2H copy and
        distribute); off, the device work shows in the stage that waits
        for it."""
        self._plane = plane
        self._step_fn = step_fn
        self._state = state
        self._flush_every = max(1, flush_every)
        self._sync_stages = sync_stages
        self._device = torch.device(device if device is not None else "cpu")
        pin = self._device.type == "cuda"
        n, s = plane.num_streams, plane.samples
        f32 = dict(dtype=torch.float32, pin_memory=pin)
        self._capture_t = torch.zeros((n, s, plane.capture_channels), **f32)
        self._render_t = torch.zeros((n, s, plane.render_channels), **f32)
        self._capture = self._capture_t.numpy()
        self._render = self._render_t.numpy()
        self._mask = np.zeros((n,), np.uint8)
        self._out = [torch.zeros((n, s, plane.capture_channels), **f32)
                     for _ in range(self._flush_every)]
        if pin:
            self._capture_dev = torch.zeros_like(self._capture_t,
                                                device=self._device)
            self._render_dev = torch.zeros_like(self._render_t,
                                               device=self._device)
        self._pending = []  # [(host output, mask copy)]
        # The host-to-device copies read the pinned batches after ``step``
        # returns; the next collect waits for them.
        self._inputs_read = None
        self.seconds = {"collect": 0.0, "step": 0.0, "out": 0.0}

    @property
    def state(self):
        return self._state

    def _sync(self):
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    def flush(self) -> None:
        """Hand every pending output to the plane's output queues."""
        if not self._pending:
            return
        t0 = time.perf_counter()
        self._sync()
        for out, mask in self._pending:
            self._plane.distribute_batch(out.numpy(), mask)
        self._pending.clear()
        self.seconds["out"] += time.perf_counter() - t0

    def step(self) -> int:
        """One engine iteration: collect, device step, copy out, and
        (every ``flush_every`` steps) distribute. Returns the number of
        streams fed."""
        t0 = time.perf_counter()
        if self._inputs_read is not None:
            self._inputs_read.synchronize()
        gathered = self._plane.collect_batch(self._capture, self._render,
                                             self._mask)
        t1 = time.perf_counter()
        self.seconds["collect"] += t1 - t0
        if gathered == 0:
            self.flush()
            return 0
        cuda = self._device.type == "cuda"
        capture, render = self._capture_t, self._render_t
        if cuda:
            self._capture_dev.copy_(capture, non_blocking=True)
            self._render_dev.copy_(render, non_blocking=True)
            self._inputs_read = torch.cuda.Event()
            self._inputs_read.record()
            capture, render = self._capture_dev, self._render_dev
        self._state, out = self._step_fn(self._state, capture, render)
        # Every row of the batched state advanced: the non-ready rows saw
        # silence, as the reference processes what arrived.
        host = self._out[len(self._pending)]
        if cuda:
            if self._sync_stages:
                self._sync()
            t2 = time.perf_counter()
            self.seconds["step"] += t2 - t1
            host.copy_(out, non_blocking=True)
            self.seconds["out"] += time.perf_counter() - t2
        else:
            host.copy_(out)
            self.seconds["step"] += time.perf_counter() - t1
        self._pending.append((host, self._mask.copy()))
        if len(self._pending) >= self._flush_every:
            self.flush()
        return gathered
