"""Per-sample ramped gain application.

Port of ``webrtc_audio_processing_tpu/ops/gain_ramp.py`` (reference:
capture_levels_adjuster/audio_samples_scaler.cc:25-95 and
agc2/gain_applier.cc:39-70): a gain that moves linearly from the previous
frame's gain to a target across the frame. Gains carry any batch shape
``(...)``; the ramps come back as ``(..., num_samples)``.
"""

from __future__ import annotations

import torch


def ramped_gains_scaler(prev_gain, target_gain, num_samples: int):
    """AudioSamplesScaler ramp: gain[i] = clamp(prev + inc*(i+1), ...).

    Matches audio_samples_scaler.cc:52-78 where the first sample already
    gets one increment step.
    """
    inc = (target_gain - prev_gain) / num_samples
    i = torch.arange(1, num_samples + 1, dtype=prev_gain.dtype,
                     device=prev_gain.device)
    g = prev_gain[..., None] + inc[..., None] * i
    lo = torch.minimum(prev_gain, target_gain)[..., None]
    hi = torch.maximum(prev_gain, target_gain)[..., None]
    return torch.minimum(torch.maximum(g, lo), hi)


def ramped_gains_applier(last_gain, current_gain, num_samples: int):
    """GainApplier ramp: sample i gets ``last + inc*i`` (gain_applier.cc:61-69
    multiplies BEFORE incrementing)."""
    inc = (current_gain - last_gain) / num_samples
    i = torch.arange(num_samples, dtype=last_gain.dtype,
                     device=last_gain.device)
    return last_gain[..., None] + inc[..., None] * i


def apply_scaler(prev_gain, target_gain, x):
    """Scale a (B, N, ...) frame with the AudioSamplesScaler ramp and the
    S16 clamp (audio_samples_scaler.cc:25-95); gains (B,). Returns (y,
    new_prev_gain)."""
    g = ramped_gains_scaler(prev_gain, target_gain, x.shape[1])
    g = g.reshape(g.shape + (1,) * (x.dim() - 2))
    return torch.clamp(x * g, -32768.0, 32767.0), target_gain
