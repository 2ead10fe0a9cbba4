"""AudioBuffer equivalent: channel adaptation + band splitting.

Port of ``webrtc_audio_processing_tpu/models/audio_buffer.py`` (reference:
modules/audio_processing/audio_buffer.cc). Full-band signals are
(B, num_frames, num_channels); banded signals are (B, num_bands, 160,
num_channels).

Resampling between the API rate and the processing rate is not ported yet
(ROADMAP Queue 1 item 11, the other rates of the configuration matrix):
a buffer whose input or output rate differs from its processing rate
raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from webrtc_audio_processing_tpu_torch.config import DownmixMethod
from webrtc_audio_processing_tpu_torch.ops import audio_util, splitting


@dataclass(frozen=True)
class BufferConfig:
    """Static geometry of one AudioBuffer (audio_buffer.h:41-52)."""

    input_rate: int
    input_num_channels: int
    buffer_rate: int
    buffer_num_channels: int
    output_rate: int
    output_num_channels: int
    downmix_method: DownmixMethod = DownmixMethod.AVERAGE_CHANNELS

    @property
    def input_num_frames(self) -> int:
        return self.input_rate // 100

    @property
    def buffer_num_frames(self) -> int:
        return self.buffer_rate // 100

    @property
    def output_num_frames(self) -> int:
        return self.output_rate // 100

    @property
    def num_bands(self) -> int:
        return splitting.num_bands_for_rate(self.buffer_rate)

    @property
    def input_resampling(self) -> bool:
        return self.input_num_frames != self.buffer_num_frames

    @property
    def output_resampling(self) -> bool:
        return self.output_num_frames != self.buffer_num_frames


def _check_supported(cfg: BufferConfig) -> None:
    if cfg.input_resampling or cfg.output_resampling:
        raise NotImplementedError(
            "AudioBuffer resampling between API and processing rates is not "
            "ported yet (ROADMAP Queue 1 item 11)"
        )


@dataclass
class AudioBufferState:
    input_resampler: None
    output_resampler: None
    split: splitting.SplittingState


def init_state(cfg: BufferConfig, batch: int, device) -> AudioBufferState:
    _check_supported(cfg)
    return AudioBufferState(
        input_resampler=None,
        output_resampler=None,
        split=splitting.init_state(cfg.num_bands, batch,
                                   cfg.buffer_num_channels, device),
    )


class AudioBuffer(nn.Module):
    def __init__(self, cfg: BufferConfig):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.splitter = splitting.SplittingFilter(cfg.num_bands)

    def copy_from(self, state: AudioBufferState, x: torch.Tensor):
        """API frame (B, input_num_frames, input_num_channels) in [-1, 1]
        -> (state, (B, buffer_num_frames, buffer_num_channels) float_s16).

        AudioBuffer::CopyFrom (audio_buffer.cc:116-166): downmix, then
        FloatToFloatS16 with clamping.
        """
        cfg = self.cfg
        if cfg.input_num_channels > 1 and cfg.buffer_num_channels == 1:
            if cfg.downmix_method == DownmixMethod.AVERAGE_CHANNELS:
                x = torch.mean(x, dim=-1, keepdim=True)
            else:
                x = x[..., :1]
        else:
            x = x[..., : cfg.buffer_num_channels]
        return state, audio_util.float_to_float_s16(x)

    def copy_to(self, state: AudioBufferState, y: torch.Tensor):
        """(B, buffer_num_frames, ch) float_s16 -> (state, API frame
        (B, output_num_frames, output_num_channels) in [-1, 1]).

        AudioBuffer::CopyTo (audio_buffer.cc:168-192): FloatS16ToFloat with
        clamping, then the first channel replicated into extra outputs.
        """
        x = audio_util.float_s16_to_float(y)
        extra = self.cfg.output_num_channels - x.shape[-1]
        if extra > 0:
            x = torch.cat([x] + [x[..., :1]] * extra, dim=-1)
        return state, x

    def split_into_frequency_bands(self, state: AudioBufferState,
                                   y: torch.Tensor):
        """(B, N, ch) -> (B, num_bands, 160, ch) (audio_buffer.cc:374)."""
        bands, new_split = self.splitter.analysis(y, state.split)
        return AudioBufferState(None, None, new_split), bands

    def merge_frequency_bands(self, state: AudioBufferState,
                              bands: torch.Tensor):
        """(B, num_bands, 160, ch) -> (B, N, ch) (audio_buffer.cc:378)."""
        y, new_split = self.splitter.synthesis(bands, state.split)
        return AudioBufferState(None, None, new_split), y
