"""Band splitting dispatcher: 1 band (<= 16 kHz), the two-band QMF
(32 kHz), the three-band filter bank (48 kHz).

Port of ``webrtc_audio_processing_tpu/ops/splitting.py`` (reference:
modules/audio_processing/splitting_filter.cc, per channel QMF :69-103 or
ThreeBandFilterBank :105-142); band frames are 160 samples.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from webrtc_audio_processing_tpu_torch.ops import qmf, three_band

SAMPLES_PER_BAND = 160


def num_bands_for_rate(rate_hz: int) -> int:
    """audio_buffer.cc ctor: bands = buffer_num_frames / 160."""
    return max(1, (rate_hz // 100) // SAMPLES_PER_BAND)


@dataclass
class SplittingState:
    """Mirrors the JAX SplittingState: two bands keep a QMF state per
    direction; the three-band state carries both directions in
    ``analysis`` and ``synthesis`` stays None."""

    analysis: qmf.QmfState | three_band.ThreeBandState | None
    synthesis: qmf.QmfState | None = None


def init_state(num_bands: int, batch: int, num_channels: int,
               device) -> SplittingState:
    if num_bands == 2:
        return SplittingState(
            analysis=qmf.init_state(batch, num_channels, device),
            synthesis=qmf.init_state(batch, num_channels, device),
        )
    if num_bands == 3:
        return SplittingState(
            analysis=three_band.init_state(batch, num_channels, device)
        )
    return SplittingState(analysis=None)


class SplittingFilter(nn.Module):
    def __init__(self, num_bands: int):
        super().__init__()
        self.num_bands = num_bands
        self.bank = {1: None, 2: qmf.Qmf(),
                     3: three_band.ThreeBandFilterBank()}[num_bands]

    def analysis(self, x: torch.Tensor, state: SplittingState):
        """(B, N, C) full band -> ((B, num_bands, 160, C) bands, state)."""
        if self.num_bands == 1:
            return x[:, None], state
        bands, new = self.bank.analysis(x, state.analysis)
        return bands, SplittingState(analysis=new, synthesis=state.synthesis)

    def synthesis(self, bands: torch.Tensor, state: SplittingState):
        """(B, num_bands, 160, C) bands -> ((B, N, C) full band, state)."""
        if self.num_bands == 1:
            return bands[:, 0], state
        if self.num_bands == 2:
            out, new = self.bank.synthesis(bands, state.synthesis)
            return out, SplittingState(analysis=state.analysis,
                                       synthesis=new)
        out, new = self.bank.synthesis(bands, state.analysis)
        return out, SplittingState(analysis=new)
