"""VAD wrapper: resample to 24 kHz, run the RNN-VAD, reset periodically.

Port of ``webrtc_audio_processing_tpu/models/agc2/vad_wrapper.py``
(reference: agc2/vad_wrapper.cc): resamples the first channel of each 10 ms
frame to 24 kHz, runs the RNN-VAD, and resets the GRU state every 1.5 s
(agc2_common.h:34 kVadResetPeriodMs).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from webrtc_audio_processing_tpu_torch.models.agc2.rnn_vad import features, rnn
from webrtc_audio_processing_tpu_torch.ops import resampler

VAD_RESET_PERIOD_FRAMES = 150  # kVadResetPeriodMs / kFrameDurationMs
_FRAME_24K = 240


@dataclass
class VadState:
    time_to_reset: torch.Tensor  # (B,) int32
    resampler: torch.Tensor | None  # (B, 2S + 32), None at 24 kHz
    features: features.FeatureState
    rnn: rnn.RnnState


def init_state(sample_rate_hz: int, batch: int, device) -> VadState:
    frame = sample_rate_hz // 100
    return VadState(
        time_to_reset=torch.full((batch,), VAD_RESET_PERIOD_FRAMES,
                                 dtype=torch.int32, device=device),
        resampler=(resampler.init_state(frame, batch, device)
                   if frame != _FRAME_24K else None),
        features=features.init_state(batch, device),
        rnn=rnn.init_state(batch, device),
    )


class VadWrapper(nn.Module):
    """VoiceActivityDetectorWrapper::Analyze (vad_wrapper.cc:96-110)."""

    def __init__(self, sample_rate_hz: int, raw_weights: dict | None = None):
        super().__init__()
        frame = sample_rate_hz // 100
        self.resampler = (resampler.PushSincResampler(frame, _FRAME_24K)
                          if frame != _FRAME_24K else None)
        self.features = features.FeatureExtractor()
        self.rnn = rnn.RnnVad(raw_weights)

    def forward(self, state: VadState, x: torch.Tensor):
        """x: (B, N, C) floatS16 -> (state, speech_probability (B,))."""
        # Periodic reset of the RNN state only (MonoVadImpl::Reset, :42).
        t = state.time_to_reset - 1
        do_reset = t <= 0
        gru = torch.where(do_reset[:, None], 0.0, state.rnn.gru)
        t = torch.where(do_reset, VAD_RESET_PERIOD_FRAMES, t).to(torch.int32)

        ch0 = x[:, :, 0]
        new_resampler = state.resampler
        if self.resampler is not None:
            new_resampler, frame24 = self.resampler(state.resampler, ch0)
        else:
            frame24 = ch0

        feat_state, feats, is_silence = self.features(state.features,
                                                      frame24)
        rnn_state, prob = self.rnn(rnn.RnnState(gru=gru), feats, is_silence)
        return (
            VadState(time_to_reset=t, resampler=new_resampler,
                     features=feat_state, rnn=rnn_state),
            prob,
        )
