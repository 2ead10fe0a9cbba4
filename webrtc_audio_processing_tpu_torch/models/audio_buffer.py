"""AudioBuffer equivalent: rate and channel adaptation + band splitting.

Port of ``webrtc_audio_processing_tpu/models/audio_buffer.py`` (reference:
modules/audio_processing/audio_buffer.cc): downmix, resampling between the
API rate and the processing rate (a PushSincResampler per channel,
audio_buffer.cc:116-192), the float_s16 conversions, and the split into
1-3 bands of 160 samples. Full-band signals are (B, num_frames,
num_channels); banded signals are (B, num_bands, 160, num_channels).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch
from torch import nn

from webrtc_audio_processing_tpu_torch.config import DownmixMethod
from webrtc_audio_processing_tpu_torch.ops import (
    audio_util,
    resampler,
    splitting,
)


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


@dataclass
class AudioBufferState:
    """The resamplers' rolling buffers (B, 2S + 32, buffer channels), None
    where the rates agree, and the band filters' state."""

    input_resampler: torch.Tensor | None
    output_resampler: torch.Tensor | None
    split: splitting.SplittingState


def init_state(cfg: BufferConfig, batch: int, device) -> AudioBufferState:
    ch = cfg.buffer_num_channels
    return AudioBufferState(
        input_resampler=(
            resampler.init_state(cfg.input_num_frames, batch, device, ch)
            if cfg.input_resampling else None),
        output_resampler=(
            resampler.init_state(cfg.buffer_num_frames, batch, device, ch)
            if cfg.output_resampling else None),
        split=splitting.init_state(cfg.num_bands, batch, ch, device),
    )


def _channels(tree, ch: int):
    """The split state's tensors cut to the first ``ch`` channels (the
    last axis of every leaf)."""
    if tree is None:
        return None
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: _channels(getattr(tree, f.name), ch)
                             for f in dataclasses.fields(tree)})
    return tree[..., :ch]


def _with_channels(full, part):
    """``full`` with its first channels replaced by ``part``'s."""
    if full is None:
        return None
    if dataclasses.is_dataclass(full):
        return type(full)(**{
            f.name: _with_channels(getattr(full, f.name),
                                   getattr(part, f.name))
            for f in dataclasses.fields(full)})
    ch = part.shape[-1]
    if ch == full.shape[-1]:
        return part
    if part.data_ptr() == full.data_ptr() and part.stride() == full.stride():
        return full  # part is full's own slice: left as it was
    return torch.cat([part, full[..., ch:]], dim=-1)


class AudioBuffer(nn.Module):
    def __init__(self, cfg: BufferConfig):
        super().__init__()
        self.cfg = cfg
        self.splitter = splitting.SplittingFilter(cfg.num_bands)
        self.input_resampler = (
            resampler.PushSincResampler(cfg.input_num_frames,
                                        cfg.buffer_num_frames)
            if cfg.input_resampling else None)
        self.output_resampler = (
            resampler.PushSincResampler(cfg.buffer_num_frames,
                                        cfg.output_num_frames)
            if cfg.output_resampling else None)

    def copy_from(self, state: AudioBufferState, x: torch.Tensor):
        """API frame (B, input_num_frames, input_num_channels) in [-1, 1]
        -> (state, (B, buffer_num_frames, buffer_num_channels) float_s16).

        AudioBuffer::CopyFrom (audio_buffer.cc:116-166): downmix, then
        resample each channel, then FloatToFloatS16 with clamping.
        """
        cfg = self.cfg
        if cfg.input_num_channels > 1 and cfg.buffer_num_channels == 1:
            if cfg.downmix_method == DownmixMethod.AVERAGE_CHANNELS:
                x = torch.mean(x, dim=-1, keepdim=True)
            else:
                x = x[..., :1]
        else:
            x = x[..., : cfg.buffer_num_channels]
        if self.input_resampler is not None:
            buf, x = self.input_resampler(state.input_resampler, x)
            state = dataclasses.replace(state, input_resampler=buf)
        return state, audio_util.float_to_float_s16(x)

    def copy_to(self, state: AudioBufferState, y: torch.Tensor):
        """(B, buffer_num_frames, ch) float_s16 -> (state, API frame
        (B, output_num_frames, output_num_channels) in [-1, 1]).

        AudioBuffer::CopyTo (audio_buffer.cc:168-192): FloatS16ToFloat with
        clamping, each channel resampled, then the first channel replicated
        into extra outputs. When a mono-mode echo controller narrowed the
        pipeline after the band split (audio_processing_impl.cc:1365-1373),
        ``y`` has fewer channels than the buffer: only those are resampled,
        and the other channels' resampler state stays as it was, like the
        reference's unused PushSincResampler instances.
        """
        x = audio_util.float_s16_to_float(y)
        if self.output_resampler is not None:
            full = state.output_resampler
            buf, x = self.output_resampler(full[..., :x.shape[-1]], x)
            state = dataclasses.replace(
                state, output_resampler=_with_channels(full, buf))
        extra = self.cfg.output_num_channels - x.shape[-1]
        if extra > 0:
            x = torch.cat([x] + [x[..., :1]] * extra, dim=-1)
        return state, x

    def split_into_frequency_bands(self, state: AudioBufferState,
                                   y: torch.Tensor):
        """(B, N, ch) -> (B, num_bands, 160, ch) (audio_buffer.cc:374)."""
        bands, new_split = self.splitter.analysis(y, state.split)
        return dataclasses.replace(state, split=new_split), bands

    def merge_frequency_bands(self, state: AudioBufferState,
                              bands: torch.Tensor):
        """(B, num_bands, 160, ch) -> (B, N, ch) (audio_buffer.cc:378).

        Like ``copy_to``, ``bands`` may carry fewer channels than the
        buffer after the mono narrowing: only those are merged, and the
        other channels' band-filter state stays as it was."""
        ch = bands.shape[-1]
        y, part = self.splitter.synthesis(bands,
                                          _channels(state.split, ch))
        return dataclasses.replace(
            state, split=_with_channels(state.split, part)), y
