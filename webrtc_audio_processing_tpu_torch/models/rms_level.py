"""RFC 6465 RMS + peak level tracker.

Port of ``webrtc_audio_processing_tpu/models/rms_level.py`` (reference:
modules/audio_processing/rms_level.cc): accumulates squared int16-domain
samples per frame. State leaves are (B,).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

MIN_LEVEL_DB = 127
INAUDIBLE_BUT_NOT_MUTED = 126  # rms_level.h / rfc6464
_MAX_SQUARED_LEVEL = 32768.0 * 32768.0
_MIN_LEVEL = 1.995262314968883e-13  # 10^(-127/10) (rms_level.cc:26)


@dataclass
class RmsLevelState:
    sum_square: torch.Tensor  # (B,) float32
    sample_count: torch.Tensor  # (B,) int32
    max_sum_square: torch.Tensor  # (B,) float32


def init_state(batch: int, device) -> RmsLevelState:
    return RmsLevelState(
        sum_square=torch.zeros(batch, dtype=torch.float32, device=device),
        sample_count=torch.zeros(batch, dtype=torch.int32, device=device),
        max_sum_square=torch.zeros(batch, dtype=torch.float32, device=device),
    )


def analyze(state: RmsLevelState, x: torch.Tensor) -> RmsLevelState:
    """Accumulate a (B, N, C) float_s16 frame (rms_level.cc:82-102).

    Each sample is clamped and truncated to int16 before squaring; all
    channels count toward the average like repeated Analyze calls.
    """
    t = torch.trunc(torch.clamp(x, -32768.0, 32767.0))
    sum_square = torch.sum(t * t, dim=(1, 2))
    return RmsLevelState(
        sum_square=state.sum_square + sum_square,
        sample_count=state.sample_count + x.shape[1] * x.shape[2],
        max_sum_square=torch.maximum(state.max_sum_square, sum_square),
    )


def _compute_rms(mean_square):
    """ComputeRms (rms_level.cc:34-48): negated dBFS int in [0, 127]."""
    faint = mean_square <= _MIN_LEVEL * _MAX_SQUARED_LEVEL
    norm = torch.clamp(mean_square, min=1e-30) / _MAX_SQUARED_LEVEL
    val = (-10.0 * torch.log10(norm) + 0.5).to(torch.int32)
    return torch.where(faint, MIN_LEVEL_DB, val)


def average(state: RmsLevelState) -> torch.Tensor:
    """The average level of RmsLevel::AverageAndPeak (rms_level.cc:126-143)
    with the kInaudibleButNotMuted bump, (B,) int32; the caller keeps or
    resets the state."""
    have = state.sample_count > 0
    mean = state.sum_square / torch.clamp(state.sample_count, min=1).to(
        torch.float32)
    avg = torch.where(have, _compute_rms(mean), MIN_LEVEL_DB)
    return torch.where(
        have & (avg == MIN_LEVEL_DB) & (state.sum_square != 0.0),
        INAUDIBLE_BUT_NOT_MUTED, avg).to(torch.int32)
