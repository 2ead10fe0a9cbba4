"""K2: per-stream contiguous row-span read, a hand-written CUDA kernel.

    out[b] = ring[b, start[b] : start[b] + W, :]

Replaces ``webrtc_audio_processing_tpu/ops/pallas_span.py`` ``_span_kernel``
(launched by ``_span_gather_tpu``, vmap rule in ``make_span_gather``), whose
oracle is ``lax.dynamic_slice``. Starts follow it: a negative start counts
from the end, then every start is clamped to [0, LP - W]. AEC3 reads every
render-ring window through it (``models/aec3/render_buffer._span``).

What bounds it on an H100: it only moves data, B x W x F x 4 bytes in and
as many out (about 80 MB each way at B = 2048, W = 19, F = 512), so the
card's bandwidth bounds it. One block per stream copies its W * F floats
as 16-byte vectors, consecutive threads on consecutive addresses. Reading
the rings in place, without this copy, is open (ROADMAP Queue 2 item 3).

Dispatch: a CUDA tensor launches the kernel (or raises); only a CPU tensor
runs the plain twin.
"""

from __future__ import annotations

import torch

from webrtc_audio_processing_tpu_torch.ops import cuda_build

# Kernel launches since the last reset; only the CUDA branch counts.
launches = 0


def clamped_starts(start: torch.Tensor, LP: int, width: int) -> torch.Tensor:
    s = start.to(torch.int64)
    return torch.where(s < 0, s + LP, s).clamp(0, LP - width)


def span_gather_plain(ring: torch.Tensor, start: torch.Tensor, width: int):
    """Plain PyTorch twin: a gather of W consecutive rows per stream."""
    B, LP, F = ring.shape
    rows = clamped_starts(start, LP, width)[:, None] + torch.arange(
        width, device=ring.device)
    return torch.gather(ring, 1, rows[:, :, None].expand(B, width, F))


def _check(ring, start, width):
    if ring.dim() != 3 or start.shape != (ring.shape[0],):
        raise ValueError(
            f"need ring (B, LP, F) and start (B,), got {tuple(ring.shape)} "
            f"and {tuple(start.shape)}")
    if not 0 <= width <= ring.shape[1]:
        raise ValueError(f"width {width} outside [0, {ring.shape[1]}]")
    if ring.dtype != torch.float32:
        raise TypeError(f"ring must be float32, got {ring.dtype}")
    if start.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"start must be int32 or int64, got {start.dtype}")
    if start.device != ring.device:
        raise ValueError(f"start is on {start.device}, ring on {ring.device}")


def span_gather_cuda(ring: torch.Tensor, start: torch.Tensor, width: int):
    """Launch the kernel on PyTorch's current stream."""
    global launches
    _check(ring, start, width)
    lib = cuda_build.library().lib
    ring = ring.contiguous()
    start = start.to(torch.int32).contiguous()
    B, LP, F = ring.shape
    out = torch.empty((B, width, F), dtype=ring.dtype, device=ring.device)
    stream = cuda_build.raw_stream(ring)
    err = lib.span_gather_f32(ring.data_ptr(), start.data_ptr(),
                              out.data_ptr(), B, LP, F, width, stream)
    cuda_build.check(err, "span_gather_f32")
    launches += 1
    return out


def span_gather(ring: torch.Tensor, start: torch.Tensor, width: int):
    """(ring (B, LP, F), start (B,) int) -> (B, width, F)."""
    if ring.device.type == "cuda":
        return span_gather_cuda(ring, start, width)
    if ring.device.type == "cpu":
        _check(ring, start, width)
        return span_gather_plain(ring, start, width)
    raise ValueError(f"unsupported device {ring.device}")
