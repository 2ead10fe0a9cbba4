"""GainController2: VAD -> levels -> adaptive gain -> limiter.

Port of ``webrtc_audio_processing_tpu/models/agc2/gain_controller2.py``
``init_state`` and ``process`` (reference: gain_controller2.cc:183-263),
with the internal RNN-VAD. ``analyze`` and the input volume controller
(ROADMAP Queue 1 item 12) are not ported yet and raise.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from webrtc_audio_processing_tpu_torch.config import (
    GainController2 as Agc2Config,
)
from webrtc_audio_processing_tpu_torch.models.agc2 import adaptive_digital as ad
from webrtc_audio_processing_tpu_torch.models.agc2 import limiter as limiter_mod
from webrtc_audio_processing_tpu_torch.models.agc2 import vad_wrapper
from webrtc_audio_processing_tpu_torch.ops.gain_ramp import (
    ramped_gains_applier,
)


def _check_supported(config: Agc2Config) -> None:
    if config.input_volume_controller.enabled:
        raise NotImplementedError(
            "the AGC2 input volume controller is not ported yet "
            "(ROADMAP Queue 1 item 12)"
        )


@dataclass
class Agc2State:
    fixed_gain_last_factor: torch.Tensor  # (B,) GainApplier memory
    limiter: limiter_mod.LimiterState
    speech_level: ad.SpeechLevelState | None
    noise_floor: ad.NoiseFloorState | None
    saturation: ad.SaturationProtectorState | None
    adaptive: ad.AdaptiveDigitalState | None
    vad: vad_wrapper.VadState | None = None
    ivc: None = None


def _fixed_gain_factor(config: Agc2Config) -> float:
    return 10.0 ** (config.fixed_digital.gain_db / 20.0)


def init_state(config: Agc2Config, sample_rate_hz: int, batch: int,
               device) -> Agc2State:
    """The internal-VAD state of gain_controller2.init_state."""
    _check_supported(config)
    adaptive_on = config.adaptive_digital.enabled
    return Agc2State(
        fixed_gain_last_factor=torch.full(
            (batch,), _fixed_gain_factor(config), dtype=torch.float32,
            device=device),
        limiter=limiter_mod.init_state(batch, device),
        speech_level=(ad.init_speech_level(config.adaptive_digital, batch,
                                           device) if adaptive_on else None),
        noise_floor=(ad.init_noise_floor(sample_rate_hz, batch, device)
                     if adaptive_on else None),
        saturation=(ad.init_saturation_protector(batch, device)
                    if adaptive_on else None),
        adaptive=(ad.init_adaptive_digital(config.adaptive_digital, batch,
                                           device) if adaptive_on else None),
        vad=(vad_wrapper.init_state(sample_rate_hz, batch, device)
             if adaptive_on else None),
    )


class GainController2(nn.Module):
    def __init__(self, config: Agc2Config, sample_rate_hz: int,
                 raw_vad_weights: dict | None = None):
        super().__init__()
        _check_supported(config)
        self.config = config
        self.sample_rate_hz = sample_rate_hz
        adaptive_on = config.adaptive_digital.enabled
        self.vad = (vad_wrapper.VadWrapper(sample_rate_hz, raw_vad_weights)
                    if adaptive_on else None)
        self.limiter = limiter_mod.Limiter()

    def forward(self, state: Agc2State, x: torch.Tensor):
        """GainController2::Process (gain_controller2.cc:183-263).

        x: (B, N, C) floatS16 full-band frame. Returns (state, y, info)
        with every info value (B,).
        """
        config = self.config
        rate = self.sample_rate_hz
        vad, speech_level, noise_floor = state.vad, state.speech_level, \
            state.noise_floor
        saturation, adaptive = state.saturation, state.adaptive

        if vad is not None:
            vad, speech_probability = self.vad(vad, x)
        else:
            speech_probability = torch.zeros(x.shape[0], dtype=x.dtype,
                                             device=x.device)

        peak_dbfs, rms_dbfs = ad.compute_audio_levels(x)

        info = {"speech_probability": speech_probability}
        if noise_floor is not None:
            noise_floor, noise_rms_dbfs = ad.noise_floor_analyze(
                noise_floor, x, rate)
            info["noise_rms_dbfs"] = noise_rms_dbfs

        if speech_level is not None:
            speech_level = ad.speech_level_update(speech_level, rms_dbfs,
                                                  speech_probability)
            info["speech_level_dbfs"] = speech_level.level_dbfs
            info["speech_level_is_confident"] = speech_level.is_confident

        y = x
        if adaptive is not None:
            saturation = ad.saturation_protector_analyze(
                saturation, speech_probability, peak_dbfs,
                speech_level.level_dbfs,
            )
            limiter_envelope_dbfs = ad.float_s16_to_dbfs(
                state.limiter.filter_state_level)
            adaptive, y = ad.adaptive_digital_process(
                config.adaptive_digital, adaptive, y, speech_probability,
                speech_level.level_dbfs, speech_level.is_confident,
                info["noise_rms_dbfs"], saturation.headroom_db,
                limiter_envelope_dbfs,
            )
            info["headroom_db"] = saturation.headroom_db

        # Fixed gain applier (:257); the ramp only matters right after a
        # runtime gain change.
        fixed_factor = torch.full_like(state.fixed_gain_last_factor,
                                       _fixed_gain_factor(config))
        g = ramped_gains_applier(state.fixed_gain_last_factor, fixed_factor,
                                 y.shape[1])
        y = y * g[:, :, None]

        new_limiter, y = self.limiter(state.limiter, y)
        return (
            Agc2State(
                fixed_gain_last_factor=fixed_factor,
                limiter=new_limiter,
                speech_level=speech_level,
                noise_floor=noise_floor,
                saturation=saturation,
                adaptive=adaptive,
                vad=vad,
            ),
            y,
            info,
        )
