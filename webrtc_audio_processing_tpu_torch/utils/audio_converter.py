"""Channel mixing and resampling composed for format conversion.

Port of ``webrtc_audio_processing_tpu/utils/audio_converter.py``
(reference: common_audio/audio_converter.{h,cc}: the Copy, Upmix, Downmix
and Resample converters that AudioConverter::Create composes, used on the
render output path, audio_processing_impl.cc:575-579). One converter
steps a batch of B streams on one device: the per-channel
PushSincResampler bank is the port's ``ops/resampler.py`` with the
channels on a trailing axis.
"""

from __future__ import annotations

import numpy as np
import torch

from webrtc_audio_processing_tpu_torch.ops import resampler as rs


class AudioConverter:
    """Converts (B, src_frames, src_channels) -> (B, dst_frames,
    dst_channels) frames of B streams on ``device`` (the card unless the
    caller asks for the CPU).

    Downmix averages the channels (DownmixConverter), upmix replicates
    channel 0 (UpmixConverter), a rate change runs the push sinc
    resampler. The order is AudioConverter::Create's: downmix before
    resampling, resampling before upmixing (the fewest resampler
    channels).
    """

    def __init__(self, src_channels: int, src_frames: int,
                 dst_channels: int, dst_frames: int, batch: int = 1,
                 device=None):
        from webrtc_audio_processing_tpu_torch import apm

        if src_channels < dst_channels and src_channels != 1:
            raise ValueError("upmix requires mono source")
        self.src_channels = src_channels
        self.src_frames = src_frames
        self.dst_channels = dst_channels
        self.dst_frames = dst_frames
        self.batch = batch
        self.device = apm._resolve_device(device)
        self._resample = src_frames != dst_frames
        if self._resample:
            self._rs = rs.PushSincResampler(src_frames, dst_frames).to(
                self.device)
            self._rs_state = rs.init_state(
                src_frames, batch, self.device,
                num_channels=min(src_channels, dst_channels))

    def step(self, x: torch.Tensor) -> torch.Tensor:
        """One frame of every stream: x (B, src_frames, src_channels)
        float32 on the converter's device."""
        want = (self.batch, self.src_frames, self.src_channels)
        if tuple(x.shape) != want:
            raise ValueError(f"need a frame of shape {want}, got "
                             f"{tuple(x.shape)}")
        if self.src_channels > self.dst_channels:
            # DownmixConverter: the channel average, to dst_channels = 1.
            x = x.mean(dim=2, keepdim=True)
            if self.dst_channels > 1:
                x = x.expand(-1, -1, self.dst_channels)
        if self._resample:
            self._rs_state, x = self._rs(self._rs_state, x)
        if x.shape[2] < self.dst_channels:
            # UpmixConverter: replicate the mono channel.
            x = x[:, :, :1].expand(-1, -1, self.dst_channels)
        return x.contiguous()

    def convert(self, src: np.ndarray) -> np.ndarray:
        """One frame of a one-stream converter, as the JAX package's
        ``convert``: src (src_frames, src_channels) float, or
        (src_frames,) mono; returns (dst_frames, dst_channels)."""
        x = np.asarray(src, np.float32)
        if x.ndim == 1:
            x = x[:, None]
        y = self.step(torch.from_numpy(x.copy())[None].to(self.device))
        return y[0].cpu().numpy()
