"""EchoAudibility with its StationarityEstimator and NoiseSpectrum.

Port of ``webrtc_audio_processing_tpu/models/aec3/echo_audibility.py``
(reference: aec3/echo_audibility.cc, aec3/stationarity_estimator.cc).
Active only when ``echo_audibility.use_stationarity_properties`` is set; its
state exists in every AecState.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from webrtc_audio_processing_tpu_torch.ops.batch import tree_where

NUM_BINS = 65
MIN_NOISE_POWER = 10.0
HANGOVER_BLOCKS = 250 // 20  # kNumBlocksPerSecond / 20
N_BLOCKS_AVERAGE_INIT_PHASE = 20
N_BLOCKS_INITIAL_PHASE = 500  # kNumBlocksPerSecond * 2
WINDOW_LENGTH = 13
THR_STATIONARITY = 10.0


@dataclass
class StationarityState:
    """StationarityEstimator + its NoiseSpectrum."""

    noise_spectrum: torch.Tensor  # (B, 65)
    block_counter: torch.Tensor  # (B,) int32
    hangovers: torch.Tensor  # (B, 65) int32
    flags: torch.Tensor  # (B, 65) bool

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass
class EchoAudibilityState:
    stationarity: StationarityState
    non_zero_render_seen: torch.Tensor  # (B,) bool

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def init_state(batch: int, device) -> EchoAudibilityState:
    return EchoAudibilityState(
        stationarity=StationarityState(
            noise_spectrum=torch.full((batch, NUM_BINS), MIN_NOISE_POWER,
                                      dtype=torch.float32, device=device),
            block_counter=torch.zeros((batch,), dtype=torch.int32,
                                      device=device),
            hangovers=torch.zeros((batch, NUM_BINS), dtype=torch.int32,
                                  device=device),
            flags=torch.zeros((batch, NUM_BINS), dtype=torch.bool,
                              device=device),
        ),
        non_zero_render_seen=torch.zeros((batch,), dtype=torch.bool,
                                         device=device),
    )


def _noise_update(st: StationarityState, avg_spectrum):
    """NoiseSpectrum::Update (stationarity_estimator.cc:162-231)."""
    counter = st.block_counter + 1
    alpha_init, alpha_fin = 0.04, 0.004
    tilt = (alpha_init - alpha_fin) / N_BLOCKS_INITIAL_PHASE
    alpha = torch.where(
        counter > N_BLOCKS_INITIAL_PHASE + N_BLOCKS_AVERAGE_INIT_PHASE,
        alpha_fin,
        alpha_init - tilt * (counter - N_BLOCKS_AVERAGE_INIT_PHASE)
    ).to(torch.float32)[:, None]
    noise0 = st.noise_spectrum
    init_upd = noise0 + (1.0 / N_BLOCKS_AVERAGE_INIT_PHASE) * avg_spectrum
    below = noise0 < avg_spectrum
    alpha_inc = alpha * (noise0 / torch.clamp(avg_spectrum, min=1e-30))
    alpha_inc = torch.where(
        (counter > N_BLOCKS_INITIAL_PHASE)[:, None]
        & (10.0 * noise0 < avg_spectrum), alpha_inc * 0.1, alpha_inc)
    up = noise0 + alpha_inc * (avg_spectrum - noise0)
    down = torch.clamp(noise0 + alpha * (avg_spectrum - noise0),
                       min=MIN_NOISE_POWER)
    noise = torch.where((counter <= N_BLOCKS_AVERAGE_INIT_PHASE)[:, None],
                        init_upd, torch.where(below, up, down))
    return st.replace(noise_spectrum=noise, block_counter=counter.to(
        torch.int32))


def _update_stationarity_flags(st: StationarityState, window, average_reverb):
    """UpdateStationarityFlags (stationarity_estimator.cc:45-78) on the
    13-spectrum window (B, 13, C, 65)."""
    acum = torch.sum(torch.mean(window, dim=2), dim=1) + average_reverb
    flags = acum < THR_STATIONARITY * (WINDOW_LENGTH * st.noise_spectrum)
    # UpdateHangover (:123-132).
    reduce = torch.all(flags, dim=1)[:, None]
    hang = torch.where(
        ~flags, HANGOVER_BLOCKS,
        torch.where(reduce, torch.clamp(st.hangovers - 1, min=0),
                    st.hangovers))
    # SmoothStationaryPerFreq (:134-148).
    sm = flags[:, :-2] & flags[:, 1:-1] & flags[:, 2:]
    smooth = torch.cat([sm[:, :1], sm, sm[:, -1:]], dim=1)
    return st.replace(flags=smooth, hangovers=hang.to(torch.int32))


def update(state: EchoAudibilityState, geo, view, s_read, s_write,
           newest_block_band0, average_reverb, delay_blocks, headroom,
           external_delay_seen, use_render_stationarity_at_init: bool):
    """EchoAudibility::Update (echo_audibility.cc:26-37), one block. One
    render spectrum is inserted per capture block, so the write-pointer
    walk is the newest spectrum (ring position s_write, a 0-d tensor).
    newest_block_band0: (B, 64, C)."""
    from webrtc_audio_processing_tpu_torch.models.aec3 import (
        render_buffer as rb,
    )

    st = state.stationarity
    too_low = torch.amax(torch.abs(newest_block_band0), dim=(1, 2)) < 10.0
    non_zero = state.non_zero_render_seen | (~external_delay_seen & ~too_low)

    start_w = torch.zeros_like(s_read) + s_write
    newest = torch.mean(
        rb.sf_spectrum(geo, rb.sf_span(geo, view, start_w, 1))[:, 0], dim=1)
    st = tree_where(non_zero, _noise_update(st, newest), st)

    lookahead = torch.clamp(headroom - delay_blocks + 1, 0, WINDOW_LENGTH - 1)
    start = torch.remainder(s_read + delay_blocks - lookahead, geo.num_blocks)
    window = rb.sf_spectrum(geo, rb.sf_span(geo, view, start, WINDOW_LENGTH))
    do_flags = external_delay_seen | use_render_stationarity_at_init
    st = tree_where(do_flags, _update_stationarity_flags(st, window,
                                                         average_reverb), st)
    return state.replace(stationarity=st, non_zero_render_seen=non_zero)


def is_block_stationary(state: EchoAudibilityState):
    """StationarityEstimator::IsBlockStationary (stationarity_estimator.cc:
    90-98): more than 75% of the bands stationary, hangover drained."""
    band_st = state.stationarity.flags & (state.stationarity.hangovers == 0)
    return torch.mean(band_st.to(torch.float32), dim=1) > 0.75


def residual_echo_scaling(state: EchoAudibilityState,
                          filter_has_had_time_to_converge,
                          use_render_stationarity_at_init: bool):
    """GetResidualEchoScaling (echo_audibility.h:40-51): 0 for stationary
    bands (hangover expired) once converged, else 1. (B, 65)."""
    band_stationary = state.stationarity.flags & (
        state.stationarity.hangovers == 0)
    active = filter_has_had_time_to_converge | use_render_stationarity_at_init
    return torch.where(band_stationary & active[:, None], 0.0, 1.0)
