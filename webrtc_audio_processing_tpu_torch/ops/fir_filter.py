"""Streaming FIR filter.

Port of ``webrtc_audio_processing_tpu/ops/fir_filter.py`` (reference:
common_audio/fir_filter.h, fir_filter_c.cc: a streaming convolution with
a (num_taps - 1)-sample history carried between Filter() calls). Batch
first: x is (B, n, ...) with time on axis 1 and the state (B, taps - 1,
...). The taps accumulate as XLA:CPU runs the JAX twin's loop: the
sum starts at tap 1's product, tap 0's is added to it by a fused
multiply-add, then each later tap's (``torch.addcmul`` rounds once). That
is XLA's order for three taps or more on every case tried; for two it
contracts either product, by the coefficients, so two taps can differ
from JAX in the last bit.
"""

from __future__ import annotations

import torch

from webrtc_audio_processing_tpu_torch.ops import batch as batch_ops


def init_state(coefficients, device, batch: int = 1) -> torch.Tensor:
    """Zero history of num_taps - 1 samples: (batch, taps - 1) float32 on
    ``device``."""
    k = max(len(coefficients) - 1, 0)
    return torch.zeros((batch, k), dtype=torch.float32, device=device)


def filter(coefficients, state: torch.Tensor, x: torch.Tensor):
    """One streaming Filter() call of B streams.

    coefficients: (taps,) b_0..b_{taps-1} (numbers); x: (B, n, ...).
    Returns (y, new_state), y[:, t] = sum_j b_j * x[:, t - j] reaching into
    the carried history.
    """
    c = batch_ops.const(tuple(float(v) for v in coefficients), x.dtype,
                        x.device)
    k = c.shape[0] - 1
    if k == 0:
        return c[0] * x, state
    ext = torch.cat([state, x], dim=1)  # (B, k + n, ...)
    n = x.shape[1]

    def tap(j):
        return ext[:, k - j:k - j + n]

    y = torch.addcmul(tap(1) * c[1], tap(0), c[0])
    for j in range(2, c.shape[0]):
        y = torch.addcmul(y, tap(j), c[j])
    return y, ext[:, n:]
