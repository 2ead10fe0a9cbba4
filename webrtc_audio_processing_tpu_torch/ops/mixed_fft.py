"""480-point real FFT for the RNN-VAD.

Port of ``webrtc_audio_processing_tpu/ops/mixed_fft.py``. The JAX package
splits 480 = 32 x 15 by hand because the TPU backend lowers
non-power-of-two FFTs to a dense DFT; the GPU's FFT library handles the
mixed radix itself.
"""

from __future__ import annotations

import torch


def rfft480(x: torch.Tensor) -> torch.Tensor:
    """(..., 480) real -> (..., 241) complex64."""
    return torch.fft.rfft(x.to(torch.float32), n=480, dim=-1)
