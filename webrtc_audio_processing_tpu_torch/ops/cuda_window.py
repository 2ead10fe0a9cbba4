"""K5: per-stream contiguous window read, a hand-written CUDA kernel.

    out[b] = buf[b, start[b] : start[b] + W]

Replaces ``webrtc_audio_processing_tpu/ops/pallas_window.py``
``_window_kernel`` (launched by ``take_windows``, vmap rule in
``make_take_window``), whose oracle is ``lax.dynamic_slice``. Starts follow
it: a negative start counts from the end of the row, then every start is
clamped to [0, L - W].

What bounds it on an H100: it only moves data, B x W x 4 bytes in and out
(3.9 MB each way at B = 2048, W = 480), a few microseconds at the card's
bandwidth, so a launch costs about what the copy does. One block per
stream copies its row with consecutive threads on consecutive addresses.
Fusing the Vorbis window that follows it is open (ROADMAP Queue 2, K5).

Dispatch: a CUDA tensor launches the kernel (or raises); only a CPU tensor
runs the plain twin.
"""

from __future__ import annotations

import torch

from webrtc_audio_processing_tpu_torch.ops import cuda_build

# Kernel launches since the last reset; only the CUDA branch counts.
launches = 0


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
    if buf.dim() != 2 or start.shape != (buf.shape[0],):
        raise ValueError(
            f"need buf (B, L) and start (B,), got {tuple(buf.shape)} and "
            f"{tuple(start.shape)}"
        )
    if not 0 <= width <= buf.shape[1]:
        raise ValueError(f"width {width} outside [0, {buf.shape[1]}]")
    if buf.dtype != torch.float32:
        raise TypeError(f"buf must be float32, got {buf.dtype}")
    if start.device != buf.device:
        raise ValueError(f"start is on {start.device}, buf on {buf.device}")


def take_windows_cuda(buf: torch.Tensor, start: torch.Tensor, width: int):
    """Launch the kernel on PyTorch's current stream."""
    global launches
    _check(buf, start, width)
    lib = cuda_build.library().lib
    buf = buf.contiguous()
    start = start.to(torch.int32).contiguous()
    B, L = buf.shape
    out = torch.empty((B, width), dtype=buf.dtype, device=buf.device)
    stream = torch.cuda.current_stream(buf.device).cuda_stream
    err = lib.take_windows_f32(
        buf.data_ptr(), start.data_ptr(), out.data_ptr(), B, L, width, stream
    )
    cuda_build.check(err, "take_windows_f32")
    launches += 1
    return out


def take_windows(buf: torch.Tensor, start: torch.Tensor, width: int):
    """(buf (B, L), start (B,) int) -> (B, width)."""
    if buf.device.type == "cuda":
        return take_windows_cuda(buf, start, width)
    if buf.device.type == "cpu":
        _check(buf, start, width)
        return take_windows_plain(buf, start, width)
    raise ValueError(f"unsupported device {buf.device}")
