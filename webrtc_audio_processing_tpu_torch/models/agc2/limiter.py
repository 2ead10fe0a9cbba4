"""AGC2 fixed-digital limiter: level envelope + interpolated gain curve.

Port of ``webrtc_audio_processing_tpu/models/agc2/limiter.py`` (reference:
agc2/fixed_digital_level_estimator.cc, agc2/interpolated_gain_curve.cc,
agc2/limiter.cc). The 20-step envelope recurrence is a short loop over
(B,) tensors; the gain lookup is a ``searchsorted`` over the static
32-point table, whose knots, slopes and offsets are registered buffers.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

SUB_FRAMES = 20  # agc2_common.h:26 kSubFramesInFrame
DECAY_CONST = 0.9971259  # fixed_digital_level_estimator.cc:37
MAX_INPUT_LEVEL_LINEAR = 36766.300710566735  # interpolated_gain_curve.h:28
ATTACK_INTERP_POWER = 8.0  # limiter.cc:40

# InterpolatedGainCurve approximation (interpolated_gain_curve.h:110-160):
# knot positions x, slopes m, offsets q.
_X = np.array(
    [30057.296875, 30148.986328125, 30240.67578125, 30424.052734375,
     30607.4296875, 30790.806640625, 30974.18359375, 31157.560546875,
     31340.939453125, 31524.31640625, 31707.693359375, 31891.0703125,
     32074.447265625, 32257.82421875, 32441.201171875, 32624.580078125,
     32807.95703125, 32991.33203125, 33174.7109375, 33358.08984375,
     33541.46484375, 33724.84375, 33819.53515625, 34009.5390625,
     34200.05859375, 34389.81640625, 34674.48828125, 35054.375,
     35434.86328125, 35814.81640625, 36195.16796875, 36575.03125],
    np.float32,
)
_M = np.array(
    [-3.515235675877192989e-07, -1.050251626111275982e-06,
     -2.085213736791047268e-06, -3.443004743530764244e-06,
     -4.773849468620028347e-06, -6.077375928725814447e-06,
     -7.353257842623861507e-06, -8.601219633419532329e-06,
     -9.821013009059242904e-06, -1.101243378798244521e-05,
     -1.217532644659513608e-05, -1.330956911260727793e-05,
     -1.441507538402220234e-05, -1.549179251014720649e-05,
     -1.653970684856176376e-05, -1.755882840370759368e-05,
     -1.854918446042574942e-05, -1.951086778717581183e-05,
     -2.044398024736437947e-05, -2.1348627342376858e-05,
     -2.222496914328075945e-05, -2.265374678245279938e-05,
     -2.242570917587727308e-05, -2.220122041762806475e-05,
     -2.19802095671184361e-05, -2.176260204578284174e-05,
     -2.133731686626560986e-05, -2.092481918225530535e-05,
     -2.052459603874012828e-05, -2.013615448959171772e-05,
     -1.975903069251216948e-05, -1.939277899509761482e-05],
    np.float32,
)
_Q = np.array(
    [1.010565876960754395, 1.031631827354431152, 1.062929749488830566,
     1.104239225387573242, 1.144973039627075195, 1.185109615325927734,
     1.224629044532775879, 1.263512492179870605, 1.301741957664489746,
     1.339300632476806641, 1.376173257827758789, 1.412345528602600098,
     1.447803974151611328, 1.482536554336547852, 1.516532182693481445,
     1.549780607223510742, 1.582272171974182129, 1.613999366760253906,
     1.644955039024353027, 1.675132393836975098, 1.704526185989379883,
     1.718986630439758301, 1.711274504661560059, 1.703639745712280273,
     1.696081161499023438, 1.688597679138183594, 1.673851132392883301,
     1.659391283988952637, 1.645209431648254395, 1.631297469139099121,
     1.617647409439086914, 1.604251742362976074],
    np.float32,
)


@dataclass
class LimiterState:
    filter_state_level: torch.Tensor  # (B,) level-estimator envelope carry
    last_scaling_factor: torch.Tensor  # (B,)


def init_state(batch: int, device) -> LimiterState:
    return LimiterState(
        filter_state_level=torch.zeros(batch, dtype=torch.float32,
                                       device=device),
        last_scaling_factor=torch.ones(batch, dtype=torch.float32,
                                       device=device),
    )


def compute_level(state_level: torch.Tensor, x: torch.Tensor):
    """FixedDigitalLevelEstimator::ComputeLevel
    (fixed_digital_level_estimator.cc:62-115).

    x: (B, N, C) floatS16 with N divisible by 20.
    Returns (new_state_level (B,), envelope (B, 20)).
    """
    # (B, N, C) -> (B, 20, N/20 * C): each row is one sub-frame.
    env = torch.amax(torch.abs(x).reshape(x.shape[0], SUB_FRAMES, -1), dim=2)
    # Shift envelope increases one step earlier (:86-92).
    env = torch.cat([torch.maximum(env[:, :-1], env[:, 1:]), env[:, -1:]],
                    dim=1)
    # Instant attack / slow decay (:94-107):
    # s = max(env, (1-decay)*env + decay*s).
    s = state_level
    out = []
    for i in range(SUB_FRAMES):
        e = env[:, i]
        s = torch.maximum(e, (1.0 - DECAY_CONST) * e + DECAY_CONST * s)
        out.append(s)
    return s, torch.stack(out, dim=1)


class Limiter(nn.Module):
    """Limiter::Process (limiter.cc:108-133)."""

    def __init__(self):
        super().__init__()
        self.register_buffer("knots", torch.from_numpy(_X))
        self.register_buffer("slopes", torch.from_numpy(_M))
        self.register_buffer("offsets", torch.from_numpy(_Q))

    def look_up_gain(self, level: torch.Tensor) -> torch.Tensor:
        """InterpolatedGainCurve::LookUpGainToApply
        (interpolated_gain_curve.cc:160-195), vectorized."""
        idx = torch.searchsorted(self.knots, level.contiguous(),
                                 side="left") - 1
        idx = torch.clamp(idx, 0, self.knots.shape[0] - 1)
        gain = self.slopes[idx] * level + self.offsets[idx]
        gain = torch.where(level <= self.knots[0], 1.0, gain)
        return torch.where(level >= MAX_INPUT_LEVEL_LINEAR, 32768.0 / level,
                           gain)

    @staticmethod
    def per_sample_factors(scaling_factors: torch.Tensor,
                           samples_per_channel: int) -> torch.Tensor:
        """ComputePerSampleSubframeFactors (limiter.cc:52-77).

        scaling_factors: (B, 21) = [last, per-subframe gains] -> (B, N).
        """
        B = scaling_factors.shape[0]
        sub = samples_per_channel // SUB_FRAMES
        start = scaling_factors[:, :-1, None]  # (B, 20, 1)
        end = scaling_factors[:, 1:, None]
        j = torch.arange(sub, dtype=scaling_factors.dtype,
                         device=scaling_factors.device)
        linear = start + (end - start) / sub * j  # (B, 20, sub)

        # Attack handling for the first sub-frame (limiter.cc:43-50,62-67).
        t = j / sub
        f0 = scaling_factors[:, 0:1]
        f1 = scaling_factors[:, 1:2]
        attack_first = torch.pow(1.0 - t, ATTACK_INTERP_POWER) * (f0 - f1) + f1
        is_attack = f0 > f1
        first = torch.where(is_attack, attack_first, linear[:, 0])
        return torch.cat([first, linear[:, 1:].reshape(B, -1)], dim=1)

    def forward(self, state: LimiterState, x: torch.Tensor):
        """x: (B, N, C) floatS16 -> (state, y)."""
        new_level, env = compute_level(state.filter_state_level, x)
        factors = torch.cat(
            [state.last_scaling_factor[:, None], self.look_up_gain(env)],
            dim=1,
        )
        g = self.per_sample_factors(factors, x.shape[1])
        y = torch.clamp(x * g[:, :, None], -32768.0, 32767.0)
        return (
            LimiterState(filter_state_level=new_level,
                         last_scaling_factor=factors[:, -1]),
            y,
        )
