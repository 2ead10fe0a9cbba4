"""Push-style windowed-sinc resampler (frame-synchronous).

Port of ``webrtc_audio_processing_tpu/ops/resampler.py`` (reference:
common_audio/resampler/sinc_resampler.cc and push_sinc_resampler.cc).
Because each push consumes exactly S source samples and produces exactly D
destination samples, every frame lands on the same sub-sample phases: the
resampler is a static gather of (D, 32) source windows from a rolling
buffer, weighted by a precomputed (D, 32) kernel matrix. The plan is derived
in float64 numpy exactly as the JAX package derives it, then cast to
float32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

KERNEL_SIZE = 32
KERNEL_OFFSET_COUNT = 32


def _sinc_scale_factor(io_ratio: float) -> float:
    """Normalized cutoff (sinc_resampler.cc:102-115)."""
    factor = 1.0 / io_ratio if io_ratio > 1.0 else 1.0
    return factor * 0.9


def make_kernel_bank(io_ratio: float) -> np.ndarray:
    """(KERNEL_OFFSET_COUNT + 1, KERNEL_SIZE) Blackman-windowed sinc bank.

    Matches SincResampler::InitializeKernel (sinc_resampler.cc:209-246).
    """
    k_alpha = 0.16
    a0, a1, a2 = 0.5 * (1 - k_alpha), 0.5, 0.5 * k_alpha
    scale = _sinc_scale_factor(io_ratio)
    bank = np.zeros((KERNEL_OFFSET_COUNT + 1, KERNEL_SIZE), np.float32)
    for offset_idx in range(KERNEL_OFFSET_COUNT + 1):
        subsample = np.float32(offset_idx) / KERNEL_OFFSET_COUNT
        i = np.arange(KERNEL_SIZE)
        pre_sinc = (np.pi * (i - KERNEL_SIZE // 2 - subsample)).astype(np.float32)
        x = (i - subsample) / KERNEL_SIZE
        window = (a0 - a1 * np.cos(2 * np.pi * x) + a2 * np.cos(4 * np.pi * x)).astype(
            np.float32
        )
        safe = np.where(pre_sinc == 0, np.float32(1.0), pre_sinc)
        sinc = np.where(
            pre_sinc == 0,
            np.float32(scale),
            np.sin(scale * safe.astype(np.float64)).astype(np.float32) / safe,
        )
        bank[offset_idx] = window * sinc
    return bank


@functools.lru_cache(maxsize=16)
def make_plan(source_frames: int, dest_frames: int):
    """Static per-frame plan for an (S -> D) push resampler (see the JAX
    twin's derivation). Returns (window_start_idx (D,) int32,
    kernel_matrix (D, 32) float32) as numpy arrays."""
    s, d = source_frames, dest_frames
    ratio = s / d
    half_k = KERNEL_SIZE // 2
    block0 = s - half_k
    n_prime = int(block0 / ratio)  # ChunkSize(): C++ size_t truncation
    v_p = n_prime * ratio
    n_more = int(np.ceil((block0 - v_p) / ratio))
    v1 = v_p + n_more * ratio - block0
    j = np.arange(d, dtype=np.float64)
    pos = v1 + s - n_more * ratio + j * ratio
    src_idx = np.floor(pos).astype(np.int64)
    subsample_remainder = pos - src_idx
    virtual_offset = subsample_remainder * KERNEL_OFFSET_COUNT
    offset_idx = np.floor(virtual_offset).astype(np.int64)
    interp = (virtual_offset - offset_idx).astype(np.float64)

    bank = make_kernel_bank(ratio).astype(np.float64)
    kernels = (1.0 - interp)[:, None] * bank[offset_idx] + interp[:, None] * bank[
        offset_idx + 1
    ]
    return src_idx.astype(np.int32), kernels.astype(np.float32)


def init_state(source_frames: int, batch: int, device,
               num_channels: int | None = None) -> torch.Tensor:
    """Rolling buffer (B, 2S + 32), or (B, 2S + 32, C) for ``num_channels``
    channels, zero-initialized (priming pass)."""
    shape = (batch, 2 * source_frames + KERNEL_SIZE)
    if num_channels is not None:
        shape += (num_channels,)
    return torch.zeros(shape, dtype=torch.float32, device=device)


class PushSincResampler(nn.Module):
    """One (S -> D) resampler for a batch of streams, each mono or with
    channels on a trailing axis."""

    def __init__(self, source_frames: int, dest_frames: int):
        super().__init__()
        self.source_frames = source_frames
        self.dest_frames = dest_frames
        src_idx, kernels = make_plan(source_frames, dest_frames)
        gather = src_idx[:, None].astype(np.int64) + np.arange(KERNEL_SIZE)
        self.register_buffer("gather_index", torch.from_numpy(gather))
        self.register_buffer("kernels", torch.from_numpy(kernels))

    def forward(self, state: torch.Tensor, frame: torch.Tensor):
        """(state (B, 2S + 32, ...), frame (B, S, ...)) -> (new_state,
        out (B, D, ...)); the trailing axes (channels) ride along.

        Output delay matches PushSincResampler: kKernelSize/2 source
        samples; the first frame's leading outputs are zeros like the
        reference's priming.
        """
        buf = torch.cat([state[:, self.source_frames:], frame], dim=1)
        windows = buf[:, self.gather_index]  # (B, D, 32, ...)
        k = self.kernels.view(self.kernels.shape + (1,) * (frame.dim() - 2))
        return buf, _dot32(windows, k)


def _dot32(windows: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """sum_j windows[:, :, j] * k[:, j] over the 32 taps in the order
    XLA:CPU gives the JAX package's ``jnp.sum(windows * k, axis=1)``: eight
    accumulators, accumulator i taking taps i, i + 8, i + 16, i + 24 by
    fused multiply-adds (``torch.addcmul`` rounds once), then summed in
    halves. Any other order differs in the last bits, which the HPF's
    poles near the unit circle downstream amplify a few hundred times."""
    lanes = 8
    w = windows.unflatten(2, (KERNEL_SIZE // lanes, lanes))
    kk = k.unflatten(1, (KERNEL_SIZE // lanes, lanes))
    acc = w[:, :, 0] * kk[:, 0]
    for j in range(1, KERNEL_SIZE // lanes):
        acc = torch.addcmul(acc, w[:, :, j], kk[:, j])
    while lanes > 1:
        lanes //= 2
        acc = acc[:, :, :lanes] + acc[:, :, lanes:]
    return acc[:, :, 0]
