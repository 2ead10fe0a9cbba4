"""K5: per-stream contiguous window read, a hand-written CUDA kernel.

    out[b] = buf[b, start[b] : start[b] + W]

Replaces ``webrtc_audio_processing_tpu/ops/pallas_window.py``
``_window_kernel`` (launched by ``take_windows``, vmap rule in
``make_take_window``), whose oracle is ``lax.dynamic_slice``. Starts follow
it: a negative start counts from the end of the row, then every start is
clamped to [0, L - W]. The kernel reads int32 and int64 starts as they
come, so the RNN-VAD's int64 starts need no conversion kernel.

What bounds it on an H100: it only moves data, B x W x 4 bytes each way
(3.9 MB at B = 2048, W = 480: 0.0023 ms at 3.35 TB/s). One warp copies one
row, 8 rows per block, with 16-byte loads and stores; the source window's
offset within its 16-byte line is shifted out in registers
(``csrc/window.cu``). At this size the call, not the copy, is most of the
time, so the wrapper does little per call: it checks and raises, but
copies nothing that is already contiguous, reads the stream handle without
building a ``torch.cuda.Stream``, allocates the output with one
``new_empty`` and calls the ctypes function whose argument types were set
once at load. Fusing the Vorbis window that follows it is open (ROADMAP
Queue 2, K5).

Dispatch: a CUDA tensor launches the kernel (or raises); only a CPU tensor
runs the plain twin.
"""

from __future__ import annotations

import torch

from webrtc_audio_processing_tpu_torch.ops import cuda_build

# Kernel launches since the last reset; only the CUDA branch counts.
launches = 0

# The start dtypes the kernel reads, by their width in bytes.
_START_BYTES = {torch.int32: 4, torch.int64: 8}


def _clamped(start: torch.Tensor, L: int, width: int) -> torch.Tensor:
    s = start.to(torch.int64)
    return torch.where(s < 0, s + L, s).clamp(0, L - width)


def take_windows_plain(buf: torch.Tensor, start: torch.Tensor, width: int):
    """Plain PyTorch twin: a gather of W consecutive columns per row."""
    L = buf.shape[1]
    idx = _clamped(start, L, width)[:, None] + torch.arange(
        width, device=buf.device
    )
    return torch.gather(buf, 1, idx)


def _check(buf, start, width):
    if buf.dim() != 2 or start.dim() != 1 or start.shape[0] != buf.shape[0]:
        raise ValueError(
            f"need buf (B, L) and start (B,), got {tuple(buf.shape)} and "
            f"{tuple(start.shape)}"
        )
    if not 0 <= width <= buf.shape[1]:
        raise ValueError(f"width {width} outside [0, {buf.shape[1]}]")
    if buf.dtype != torch.float32:
        raise TypeError(f"buf must be float32, got {buf.dtype}")
    if start.dtype not in _START_BYTES:
        raise TypeError(f"start must be int32 or int64, got {start.dtype}")
    if start.device != buf.device:
        raise ValueError(f"start is on {start.device}, buf on {buf.device}")


def take_windows_cuda(buf: torch.Tensor, start: torch.Tensor, width: int):
    """Launch the kernel on PyTorch's current stream."""
    global launches
    _check(buf, start, width)
    if not buf.is_contiguous():
        buf = buf.contiguous()
    if not start.is_contiguous():
        start = start.contiguous()
    B, L = buf.shape
    out = buf.new_empty((B, width))
    err = cuda_build.library().lib.take_windows_f32(
        buf.data_ptr(), start.data_ptr(), _START_BYTES[start.dtype],
        out.data_ptr(), B, L, width, cuda_build.raw_stream(buf))
    cuda_build.check(err, "take_windows_f32")
    launches += 1
    return out


def take_windows(buf: torch.Tensor, start: torch.Tensor, width: int):
    """(buf (B, L) float32, start (B,) int32 or int64) -> (B, width)."""
    if buf.is_cuda:
        return take_windows_cuda(buf, start, width)
    if buf.is_cpu:
        _check(buf, start, width)
        return take_windows_plain(buf, start, width)
    raise ValueError(f"unsupported device {buf.device}")
