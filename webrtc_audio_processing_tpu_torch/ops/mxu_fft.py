"""Small real FFTs over the last axis.

Port of ``webrtc_audio_processing_tpu/ops/mxu_fft.py``. The JAX package
evaluates these as DFT matrix products on the TPU's matrix unit and as
``jnp.fft`` elsewhere; on a GPU the library FFT is the direct choice, so
only the ``jnp.fft`` branch is ported.
"""

from __future__ import annotations

import torch


def rfft(x: torch.Tensor, n: int | None = None) -> torch.Tensor:
    """(..., n) real -> (..., n//2+1) complex64."""
    return torch.fft.rfft(x.to(torch.float32), n=n, dim=-1)


def irfft(X: torch.Tensor, n: int) -> torch.Tensor:
    """(..., n//2+1) complex -> (..., n) float32."""
    return torch.fft.irfft(X, n=n, dim=-1)
