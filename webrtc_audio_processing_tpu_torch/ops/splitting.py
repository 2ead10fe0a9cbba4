"""Band splitting dispatcher, three-band branch.

Port of ``webrtc_audio_processing_tpu/ops/splitting.py`` (reference:
modules/audio_processing/splitting_filter.cc). The 48 kHz three-band filter
bank is ported; 16 kHz and below need no split. The 32 kHz two-band QMF is
ROADMAP Queue 1 item 11 and raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from webrtc_audio_processing_tpu_torch.ops import three_band

SAMPLES_PER_BAND = 160


def num_bands_for_rate(rate_hz: int) -> int:
    """audio_buffer.cc ctor: bands = buffer_num_frames / 160."""
    return max(1, (rate_hz // 100) // SAMPLES_PER_BAND)


def _check_supported(num_bands: int) -> None:
    if num_bands == 2:
        raise NotImplementedError(
            "the 32 kHz two-band QMF split is not ported yet "
            "(ROADMAP Queue 1 item 11)"
        )


@dataclass
class SplittingState:
    """Mirrors the JAX SplittingState: the three-band state carries both
    directions in ``analysis``; ``synthesis`` stays None."""

    analysis: three_band.ThreeBandState | None
    synthesis: None = None


def init_state(num_bands: int, batch: int, num_channels: int,
               device) -> SplittingState:
    _check_supported(num_bands)
    if num_bands == 3:
        return SplittingState(
            analysis=three_band.init_state(batch, num_channels, device)
        )
    return SplittingState(analysis=None)


class SplittingFilter(nn.Module):
    def __init__(self, num_bands: int):
        super().__init__()
        _check_supported(num_bands)
        self.num_bands = num_bands
        self.bank = (three_band.ThreeBandFilterBank()
                     if num_bands == 3 else None)

    def analysis(self, x: torch.Tensor, state: SplittingState):
        """(B, N, C) full band -> ((B, num_bands, 160, C) bands, state)."""
        if self.num_bands == 1:
            return x[:, None], state
        bands, new = self.bank.analysis(x, state.analysis)
        return bands, SplittingState(analysis=new)

    def synthesis(self, bands: torch.Tensor, state: SplittingState):
        """(B, num_bands, 160, C) bands -> ((B, N, C) full band, state)."""
        if self.num_bands == 1:
            return bands[:, 0], state
        out, new = self.bank.synthesis(bands, state.analysis)
        return out, SplittingState(analysis=new)
