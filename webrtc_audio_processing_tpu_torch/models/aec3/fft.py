"""128-point FFT helpers for AEC3.

Port of ``webrtc_audio_processing_tpu/models/aec3/fft.py`` (reference:
aec3/aec3_fft.{h,cc}, aec3/fft_data.h). ``FftData`` is a complex64 tensor of
shape (..., 65); the reference's unnormalized inverse is ``64 * irfft``.
The JAX twin's matrix-product DFT is a TPU detour: here it is ``torch.fft``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

FFT_LENGTH = 128
BLOCK_SIZE = 64
NUM_BINS = 65

# kHanning64 (aec3_fft.cc:40-54) = symmetric Hann: sin^2(pi k / 63).
HANNING64 = (np.sin(np.pi * np.arange(64) / 63.0) ** 2).astype(np.float32)
# kSqrtHanning128 = sqrt(hanning-periodic(128)) = sin(pi k / 128).
SQRT_HANNING128 = np.sin(np.pi * np.arange(128) / 128.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def window(name: str, device: torch.device) -> torch.Tensor:
    table = {"hanning": HANNING64, "sqrt_hanning": SQRT_HANNING128}[name]
    return torch.from_numpy(table).to(device)


def fft(x: torch.Tensor) -> torch.Tensor:
    """Unnormalized forward FFT of (..., 128) -> (..., 65) complex64."""
    return torch.fft.rfft(x, n=FFT_LENGTH, dim=-1)


def ifft_unnormalized(X: torch.Tensor) -> torch.Tensor:
    """Aec3Fft::Ifft: 64 times the exact inverse, (..., 128)."""
    return torch.fft.irfft(X, n=FFT_LENGTH, dim=-1) * float(BLOCK_SIZE)


def zero_padded_fft(x: torch.Tensor, window_name: str = "rectangular"):
    """Aec3Fft::ZeroPaddedFft (aec3_fft.cc:116-140): 64 zeros, then x."""
    if window_name == "hanning":
        x = x * window("hanning", x.device)
    return fft(torch.cat([torch.zeros_like(x), x], dim=-1))


def padded_fft(x: torch.Tensor, x_old: torch.Tensor,
               window_name: str = "rectangular"):
    """Aec3Fft::PaddedFft (aec3_fft.cc:142-170): [x_old, x], windowed."""
    v = torch.cat([x_old, x], dim=-1)
    if window_name == "sqrt_hanning":
        v = v * window("sqrt_hanning", v.device)
    return fft(v)


def spectrum(X: torch.Tensor) -> torch.Tensor:
    """FftData::Spectrum: |X|^2 per bin (fft_data.h:60-78)."""
    return X.real ** 2 + X.imag ** 2
