"""Post filter: full-band low-pass after AEC3 at 48 kHz.

Port of ``webrtc_audio_processing_tpu/models/post_filter.py`` (reference:
modules/audio_processing/post_filter.cc): created only for 48 kHz
processing with the echo canceller on, it removes content above 19.5 kHz
with 4 cascaded cheby2 biquads per channel, through K1.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from webrtc_audio_processing_tpu_torch.ops import biquad

# signal.iirdesign(19200*2/48000, 19500*2/48000, 3, 20, ftype='cheby2',
# output='sos') (post_filter.cc:26-41).
COEFFS_B_48K = np.array(
    [
        [0.56142156, 1.11499931, 0.56142156],
        [1.0, 1.88944170, 1.0],
        [1.0, 1.76057310, 1.0],
        [1.0, 1.67448535, 1.0],
    ],
    np.float32,
)
COEFFS_A_48K = np.array(
    [
        [1.57914249, 0.63379496],
        [1.55130066, 0.68708719],
        [1.53001328, 0.78591224],
        [1.56506670, 0.92096576],
    ],
    np.float32,
)

NUM_SECTIONS = 4


@dataclass
class PostFilterState:
    filt: biquad.BiquadCascadeState


def is_needed(sample_rate_hz: int) -> bool:
    """PostFilter::CreateIfNeeded (post_filter.cc:44-52)."""
    return sample_rate_hz == 48000


def init_state(batch: int, num_channels: int, device) -> PostFilterState:
    return PostFilterState(
        filt=biquad.init_state(NUM_SECTIONS, batch, num_channels, device))


class PostFilter(nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("coeffs", torch.from_numpy(
            biquad.pack_coeffs(COEFFS_B_48K, COEFFS_A_48K)))

    def forward(self, state: PostFilterState, x: torch.Tensor):
        """Filter the (B, N, C) full-band signal. Returns (state, y)."""
        new_filt, y = biquad.process(self.coeffs, state.filt, x)
        return PostFilterState(filt=new_filt), y
