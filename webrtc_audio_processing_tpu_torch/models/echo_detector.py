"""Residual echo detector: render/capture power correlation analytics.

Port of ``webrtc_audio_processing_tpu/models/echo_detector.py`` (reference:
modules/audio_processing/residual_echo_detector.cc and echo_detector/).
Per 10 ms frame the render power enters a 30-entry FIFO and the capture
power is correlated against the render power at 650 lookback delays, one
(B, 650) update per frame. The APM creates it whenever the echo canceller
is on.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from webrtc_audio_processing_tpu_torch.ops.batch import tree_where

LOOKBACK_FRAMES = 650
RENDER_BUFFER_SIZE = 30
ALPHA = 0.001
AGGREGATION_BUFFER_SIZE = 10 * 100
MAX_DECAY = 0.99  # moving_max.cc:27


@dataclass
class EchoDetectorState:
    render_buffer: torch.Tensor  # (B, 30) FIFO of render powers
    rb_next_insert: torch.Tensor  # (B,) int32
    rb_size: torch.Tensor  # (B,) int32
    frames_since_zero_size: torch.Tensor  # (B,) int32
    first_process_call: torch.Tensor  # (B,) bool
    # Render statistics at each lookback delay, newest at index 0.
    render_power: torch.Tensor  # (B, 650)
    render_power_mean: torch.Tensor  # (B, 650)
    render_power_std: torch.Tensor  # (B, 650)
    render_mean: torch.Tensor  # (B,)
    render_var: torch.Tensor
    capture_mean: torch.Tensor
    capture_var: torch.Tensor
    covariances: torch.Tensor  # (B, 650)
    echo_likelihood: torch.Tensor  # (B,)
    reliability: torch.Tensor
    max_value: torch.Tensor
    max_counter: torch.Tensor  # (B,) int32

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def init_state(batch: int, device) -> EchoDetectorState:
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)

    def z():
        return torch.zeros((batch,), **f32)

    return EchoDetectorState(
        render_buffer=torch.zeros((batch, RENDER_BUFFER_SIZE), **f32),
        rb_next_insert=torch.zeros((batch,), **i32),
        rb_size=torch.zeros((batch,), **i32),
        frames_since_zero_size=torch.zeros((batch,), **i32),
        first_process_call=torch.ones((batch,), dtype=torch.bool,
                                      device=device),
        render_power=torch.zeros((batch, LOOKBACK_FRAMES), **f32),
        render_power_mean=torch.zeros((batch, LOOKBACK_FRAMES), **f32),
        render_power_std=torch.zeros((batch, LOOKBACK_FRAMES), **f32),
        render_mean=z(), render_var=z(), capture_mean=z(), capture_var=z(),
        covariances=torch.zeros((batch, LOOKBACK_FRAMES), **f32),
        echo_likelihood=z(), reliability=z(), max_value=z(),
        max_counter=torch.zeros((batch,), **i32),
    )


def analyze_render_audio(state: EchoDetectorState, render: torch.Tensor):
    """AnalyzeRenderAudio (residual_echo_detector.cc:52-71); render
    (B, N, C)."""
    power = torch.mean(render.flatten(1) ** 2, dim=1)
    zero = state.rb_size == 0
    overflow = ~zero & (state.frames_since_zero_size >= RENDER_BUFFER_SIZE)
    rb_size = torch.where(overflow, state.rb_size - 1, state.rb_size)
    frames = torch.where(zero | overflow, 0,
                         state.frames_since_zero_size) + 1
    slots = torch.arange(RENDER_BUFFER_SIZE, device=render.device)
    onehot = slots[None, :] == state.rb_next_insert[:, None]
    return state.replace(
        render_buffer=torch.where(onehot, power[:, None], state.render_buffer),
        rb_next_insert=torch.remainder(state.rb_next_insert + 1,
                                       RENDER_BUFFER_SIZE).to(torch.int32),
        rb_size=torch.clamp(rb_size + 1, max=RENDER_BUFFER_SIZE).to(
            torch.int32),
        frames_since_zero_size=frames.to(torch.int32),
    )


def analyze_capture_audio(state: EchoDetectorState, capture: torch.Tensor):
    """AnalyzeCaptureAudio (residual_echo_detector.cc:73-160); capture
    (B, N, C)."""
    rb_size = torch.where(state.first_process_call, 0, state.rb_size)
    has_render = rb_size > 0
    oldest = torch.remainder(state.rb_next_insert - rb_size,
                             RENDER_BUFFER_SIZE)
    slots = torch.arange(RENDER_BUFFER_SIZE, device=capture.device)
    render_power = torch.sum(
        torch.where(slots[None, :] == oldest[:, None], state.render_buffer,
                    0.0), dim=1)
    rb_size = torch.where(has_render, rb_size - 1, rb_size).to(torch.int32)

    r_mean = (1 - ALPHA) * state.render_mean + ALPHA * render_power
    r_var = (1 - ALPHA) * state.render_var + ALPHA * (
        render_power - r_mean) ** 2
    r_std = torch.sqrt(r_var)

    rp = torch.cat([render_power[:, None], state.render_power[:, :-1]], 1)
    rpm = torch.cat([r_mean[:, None], state.render_power_mean[:, :-1]], 1)
    rps = torch.cat([r_std[:, None], state.render_power_std[:, :-1]], 1)

    capture_power = torch.mean(capture.flatten(1) ** 2, dim=1)
    c_mean = (1 - ALPHA) * state.capture_mean + ALPHA * capture_power
    c_var = (1 - ALPHA) * state.capture_var + ALPHA * (
        capture_power - c_mean) ** 2
    c_std = torch.sqrt(c_var)

    cov = (1 - ALPHA) * state.covariances + ALPHA * (
        (capture_power - c_mean)[:, None] * (rp - rpm))
    ncc = cov / (c_std[:, None] * rps + 1e-4)
    likelihood = torch.clamp(torch.max(ncc, dim=1).values, min=0.0)
    reliability = (1.0 - ALPHA) * state.reliability + ALPHA
    likelihood = torch.clamp(likelihood * reliability, max=1.0)

    at_end = state.max_counter >= AGGREGATION_BUFFER_SIZE - 1
    decayed = torch.where(at_end, state.max_value * MAX_DECAY,
                          state.max_value)
    counter = torch.where(at_end, state.max_counter, state.max_counter + 1)
    rising = likelihood > decayed
    new_max = torch.where(rising, likelihood, decayed)
    counter = torch.where(rising, 0, counter).to(torch.int32)

    not_first = torch.zeros_like(state.first_process_call)
    updated = state.replace(
        rb_size=rb_size, first_process_call=not_first,
        render_power=rp, render_power_mean=rpm, render_power_std=rps,
        render_mean=r_mean, render_var=r_var,
        capture_mean=c_mean, capture_var=c_var, covariances=cov,
        echo_likelihood=likelihood, reliability=reliability,
        max_value=new_max, max_counter=counter,
    )
    skipped = state.replace(rb_size=rb_size, first_process_call=not_first)
    return tree_where(has_render, updated, skipped)


def get_metrics(state: EchoDetectorState) -> dict:
    """EchoDetector::GetMetrics (residual_echo_detector.cc:186-191)."""
    return {
        "echo_likelihood": state.echo_likelihood,
        "echo_likelihood_recent_max": state.max_value,
    }
