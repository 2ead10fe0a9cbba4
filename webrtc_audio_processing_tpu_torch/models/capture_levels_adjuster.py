"""Capture level adjustment: pre and post gain, emulated analog mic gain.

Port of ``webrtc_audio_processing_tpu/models/capture_levels_adjuster.py``
(reference: capture_levels_adjuster/capture_levels_adjuster.cc): a pre
scaler (the pre gain times level/255 when analog mic gain emulation is on,
capture_levels_adjuster.cc:23-44) and a post scaler, both ramped over the
frame's samples (audio_samples_scaler.cc). Every leaf is (B,).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from webrtc_audio_processing_tpu_torch.ops import gain_ramp

MIN_ANALOG_MIC_GAIN_LEVEL = 0
MAX_ANALOG_MIC_GAIN_LEVEL = 255


@dataclass
class CaptureLevelsAdjusterState:
    pre_gain: torch.Tensor  # (B,) the configured pre gain
    post_gain: torch.Tensor  # (B,)
    emulated_level: torch.Tensor  # (B,) int32 in [0, 255]
    pre_scaler_gain: torch.Tensor  # (B,) the last applied gain (ramp start)
    post_scaler_gain: torch.Tensor  # (B,)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def _pre_adjustment_gain(pre_gain, emulated_level, emulation_enabled: bool):
    """ComputePreGain (capture_levels_adjuster.cc:37-44)."""
    if not emulation_enabled:
        return pre_gain
    return pre_gain * (emulated_level.to(torch.float32)
                       / MAX_ANALOG_MIC_GAIN_LEVEL)


def init_state(pre_gain: float, post_gain: float, initial_level: int,
               emulation_enabled: bool, batch: int,
               device) -> CaptureLevelsAdjusterState:
    def full(v, dtype=torch.float32):
        return torch.full((batch,), v, dtype=dtype, device=device)

    pre, level = full(pre_gain), full(initial_level, torch.int32)
    return CaptureLevelsAdjusterState(
        pre_gain=pre,
        post_gain=full(post_gain),
        emulated_level=level,
        pre_scaler_gain=_pre_adjustment_gain(pre, level, emulation_enabled),
        post_scaler_gain=full(post_gain),
    )


def apply_pre_level_adjustment(state: CaptureLevelsAdjusterState, x,
                               emulation_enabled: bool):
    """Scale the (B, N, C) capture frame by the ramped pre gain."""
    target = _pre_adjustment_gain(state.pre_gain, state.emulated_level,
                                  emulation_enabled)
    y, new_prev = gain_ramp.apply_scaler(state.pre_scaler_gain, target, x)
    return state.replace(pre_scaler_gain=new_prev), y


def apply_post_level_adjustment(state: CaptureLevelsAdjusterState, x):
    y, new_prev = gain_ramp.apply_scaler(state.post_scaler_gain,
                                         state.post_gain, x)
    return state.replace(post_scaler_gain=new_prev), y


def set_analog_mic_gain_level(state: CaptureLevelsAdjusterState, level):
    """CaptureLevelsAdjuster::SetAnalogMicGainLevel (.cc:80-88); ``level``
    an int or a (B,) tensor."""
    level = torch.as_tensor(level, dtype=torch.int32,
                            device=state.emulated_level.device)
    level = torch.clamp(level, MIN_ANALOG_MIC_GAIN_LEVEL,
                        MAX_ANALOG_MIC_GAIN_LEVEL)
    return state.replace(
        emulated_level=level.expand_as(state.emulated_level).clone())
