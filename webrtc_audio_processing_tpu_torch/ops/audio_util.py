"""Sample-format conversions and level utilities.

Port of ``webrtc_audio_processing_tpu/ops/audio_util.py`` (reference:
webrtc/common_audio/include/audio_util.h:47-120). Naming follows the
reference convention:

* ``s16``      — int16 samples in [-32768, 32767]
* ``float``    — float samples in [-1, 1]
* ``float_s16``— float samples in [-32768, 32768]
* ``dbfs``     — dB relative to int16 full scale, in [-90.3, 0]
"""

from __future__ import annotations

import torch

S16_SCALE = 32768.0
# -20 * log10(32768) (audio_util.h:100).
MIN_DBFS = -90.30899869919436


def _round_half_away(v: torch.Tensor) -> torch.Tensor:
    return torch.trunc(v + torch.copysign(torch.full_like(v, 0.5), v))


def s16_to_float(x):
    """int16 -> [-1, 1] float (audio_util.h:47-50)."""
    return x.to(torch.float32) * (1.0 / S16_SCALE)


def float_to_s16(x):
    """[-1, 1] float -> int16 with round-half-away-from-zero (audio_util.h:58-63)."""
    v = torch.clamp(x.to(torch.float32) * S16_SCALE, -32768.0, 32767.0)
    return _round_half_away(v).to(torch.int16)


def float_s16_to_s16(x):
    """float_s16 -> int16 with reference rounding (audio_util.h:52-56)."""
    v = torch.clamp(x.to(torch.float32), -32768.0, 32767.0)
    return _round_half_away(v).to(torch.int16)


def float_to_float_s16(x):
    """[-1, 1] float -> float_s16 (clamped; audio_util.h:65-69)."""
    return torch.clamp(x.to(torch.float32), -1.0, 1.0) * S16_SCALE


def float_s16_to_float(x):
    """float_s16 -> [-1, 1] float (clamped; audio_util.h:71-77)."""
    return torch.clamp(x.to(torch.float32), -S16_SCALE, S16_SCALE) * (
        1.0 / S16_SCALE
    )


def s16_to_float_s16(x):
    """int16 -> float_s16 (plain cast; audio_util.h:80)."""
    return x.to(torch.float32)


def db_to_ratio(v):
    """dB -> linear amplitude ratio (audio_util.h:87-89)."""
    return torch.pow(10.0, v.to(torch.float32) / 20.0)


def dbfs_to_float_s16(v):
    """dBFS -> float_s16 amplitude (audio_util.h:91-94)."""
    return db_to_ratio(v) * S16_SCALE


def float_s16_to_dbfs(v):
    """Non-negative float_s16 amplitude -> dBFS (audio_util.h:96-105)."""
    v = v.to(torch.float32)
    return torch.where(
        v <= 1.0,
        MIN_DBFS,
        20.0 * torch.log10(torch.clamp(v, min=1.0)) + MIN_DBFS,
    )


def downmix_average(x, dim=-1):
    """Average channels to mono (DownmixMethod::kAverageChannels)."""
    return torch.mean(x.to(torch.float32), dim=dim)


def downmix_first_channel(x, dim=-1):
    """Take the first channel (DownmixMethod::kUseFirstChannel)."""
    return x.select(dim, 0)
