"""MultiChannelContentDetector and ConfigSelector for AEC3.

Port of ``webrtc_audio_processing_tpu/models/aec3/
multi_channel_content_detector.py`` (reference:
aec3/multi_channel_content_detector.cc, aec3/config_selector.cc). The
geometry is static, so a flip of the persistent flag is surfaced in the
metrics for the host to re-create the geometry, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

NUM_FRAMES_PER_SECOND = 100


@dataclass
class MultiChannelContentDetectorState:
    persistent_detected: torch.Tensor  # (B,) bool
    temporary_detected: torch.Tensor  # (B,) bool
    consecutive_frames_with_stereo: torch.Tensor  # (B,) int32
    frames_since_stereo_last: torch.Tensor  # (B,) int32

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def init_state(detect_stereo_content: bool, num_render_channels: int,
               batch: int, device) -> MultiChannelContentDetectorState:
    def full(v, dtype):
        return torch.full((batch,), v, dtype=dtype, device=device)

    return MultiChannelContentDetectorState(
        persistent_detected=full(
            (not detect_stereo_content) and num_render_channels > 1,
            torch.bool),
        temporary_detected=full(False, torch.bool),
        consecutive_frames_with_stereo=full(0, torch.int32),
        frames_since_stereo_last=full(0, torch.int32),
    )


def update(state: MultiChannelContentDetectorState, render_bands,
           detect_stereo_content: bool, detection_threshold: float,
           timeout_threshold_seconds: int, hysteresis_seconds: float):
    """UpdateDetection (multi_channel_content_detector.cc:103-141).

    render_bands: (B, bands, N, C). Returns (state, changed (B,) bool)."""
    no_change = torch.zeros_like(state.persistent_detected)
    if not detect_stereo_content or render_bands.shape[-1] < 2:
        return state, no_change
    has_stereo = torch.any(
        (torch.abs(render_bands[..., 0] - render_bands[..., 1])
         > detection_threshold).flatten(1), dim=1)
    consecutive = torch.where(
        has_stereo, state.consecutive_frames_with_stereo + 1, 0
    ).to(torch.int32)
    since_last = torch.where(
        has_stereo, 0, state.frames_since_stereo_last + 1).to(torch.int32)
    hysteresis_frames = int(hysteresis_seconds * NUM_FRAMES_PER_SECOND)
    persistent = (consecutive > hysteresis_frames) | state.persistent_detected
    if timeout_threshold_seconds > 0:
        timeout_frames = timeout_threshold_seconds * NUM_FRAMES_PER_SECOND
        persistent = persistent & ~(since_last >= timeout_frames)
    temporary = has_stereo & ~persistent
    changed = persistent != state.persistent_detected
    return (
        MultiChannelContentDetectorState(
            persistent_detected=persistent,
            temporary_detected=temporary,
            consecutive_frames_with_stereo=consecutive,
            frames_since_stereo_last=since_last,
        ),
        changed,
    )


def select_config(mono_config, multichannel_config, multichannel_content):
    """ConfigSelector::Update (config_selector.cc:63-70): the multichannel
    config applies only when persistent multichannel content is present."""
    if multichannel_content and multichannel_config is not None:
        return multichannel_config
    return mono_config
