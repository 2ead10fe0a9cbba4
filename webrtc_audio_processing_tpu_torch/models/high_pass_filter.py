"""High-pass filter submodule.

Port of ``webrtc_audio_processing_tpu/models/high_pass_filter.py``
(reference: modules/audio_processing/high_pass_filter.cc): three cascaded
biquads per channel, run through K1. The coefficients of one rate are a
registered buffer; the rate is chosen when the module is built.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from webrtc_audio_processing_tpu_torch.ops import biquad

NUM_SECTIONS = 3


@dataclass
class HighPassFilterState:
    filt: biquad.BiquadCascadeState


def init_state(batch: int, num_channels: int,
               device) -> HighPassFilterState:
    return HighPassFilterState(
        filt=biquad.init_state(NUM_SECTIONS, batch, num_channels, device)
    )


class HighPassFilter(nn.Module):
    def __init__(self, sample_rate_hz: int):
        super().__init__()
        self.sample_rate_hz = sample_rate_hz
        b, a = biquad.HPF_COEFFS[sample_rate_hz]
        self.register_buffer("coeffs",
                             torch.from_numpy(biquad.pack_coeffs(b, a)))

    def forward(self, state: HighPassFilterState, x: torch.Tensor):
        """Filter (B, N, C) at the module's rate. Returns (state, y)."""
        new_filt, y = biquad.process(self.coeffs, state.filt, x)
        return HighPassFilterState(filt=new_filt), y
