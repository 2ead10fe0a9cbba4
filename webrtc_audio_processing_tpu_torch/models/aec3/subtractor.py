"""AEC3 subtractor: partitioned-FFT adaptive filters (refined + coarse).

Port of ``webrtc_audio_processing_tpu/models/aec3/subtractor.py``
(reference: aec3/adaptive_fir_filter.cc, aec3/refined_filter_update_gain.cc,
aec3/coarse_filter_update_gain.cc, aec3/subtractor.cc,
aec3/render_signal_analyzer.cc). The filters are dense (B, C_cap, P,
C_ren, 65) complex tensors; apply and adapt are einsums over the render FFT
window. Only the pair path the main path runs is ported:
``process_pair`` (the JAX package's default, with its megakernel off).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from webrtc_audio_processing_tpu_torch.models.aec3 import fft as afft
from webrtc_audio_processing_tpu_torch.models.aec3.config import (
    EchoCanceller3Config,
)
from webrtc_audio_processing_tpu_torch.ops.batch import take, tile, tree_where

NUM_BINS = 65
BLOCK_SIZE = 64
H_ERROR_INITIAL = 10000.0  # refined_filter_update_gain.cc:41
POOR_EXCITATION_COUNTER_INITIAL = 1000
_I32 = torch.int32


# ----------------------------------------------------------- signal analyzer


@dataclass
class RenderSignalAnalyzerState:
    """render_signal_analyzer.h:54-58."""

    narrow_band_counters: torch.Tensor  # (B, 63) int32
    narrow_peak_band: torch.Tensor  # (B,) int32, -1 = none
    narrow_peak_counter: torch.Tensor  # (B,) int32


def init_analyzer(batch: int, device) -> RenderSignalAnalyzerState:
    return RenderSignalAnalyzerState(
        narrow_band_counters=torch.zeros((batch, 63), dtype=_I32,
                                         device=device),
        narrow_peak_band=torch.full((batch,), -1, dtype=_I32, device=device),
        narrow_peak_counter=torch.zeros((batch,), dtype=_I32, device=device),
    )


def analyzer_update(config: EchoCanceller3Config,
                    state: RenderSignalAnalyzerState,
                    spec_win: torch.Tensor, block0: torch.Tensor,
                    delay_partitions: torch.Tensor):
    """RenderSignalAnalyzer::Update (render_signal_analyzer.cc:121-131),
    reading the spectra window (B, W, C, 65) at the read position and
    RenderBuffer::GetBlock(0) (B, bands, 64, C); the delay is valid."""
    # IdentifySmallNarrowBandRegions (:24-50).
    X2 = take(spec_win, delay_partitions)  # (B, C, 65)
    narrow = X2[..., 1:64] > 3.0 * torch.maximum(X2[..., 0:63],
                                                 X2[..., 2:65])
    any_narrow = torch.any(narrow, dim=1)  # (B, 63)
    counters = torch.where(any_narrow, state.narrow_band_counters + 1, 0)

    # IdentifyStrongNarrowBandComponent (:53-111).
    freeze = config.filter.refined.length_blocks
    peak_counter = state.narrow_peak_counter + 1
    peak_band = torch.where(
        (state.narrow_peak_band >= 0) & (peak_counter > freeze), -1,
        state.narrow_peak_band)

    X2_latest = spec_win[:, 0]  # (B, C, 65)
    peak_bins = torch.argmax(X2_latest, dim=-1)  # (B, C)
    ks = torch.arange(NUM_BINS, device=X2.device)
    lo_mask = (ks >= torch.clamp(peak_bins - 14, min=0)[..., None]) & (
        ks < (peak_bins - 4)[..., None])
    hi_mask = (ks >= (peak_bins + 5)[..., None]) & (
        ks < torch.clamp(peak_bins + 15, max=NUM_BINS)[..., None])
    non_peak = torch.max(torch.where(lo_mask | hi_mask, X2_latest, 0.0),
                         dim=-1)[0]  # (B, C)
    max_abs = torch.max(torch.abs(block0[:, 0]), dim=1)[0]  # (B, C)
    if block0.shape[1] > 1:
        max_abs = torch.maximum(max_abs,
                                torch.max(torch.abs(block0[:, 1]), dim=1)[0])
    peak_level = torch.gather(X2_latest, 2, peak_bins[..., None])[..., 0]
    strong = (peak_bins > 0) & (max_abs > 100.0) & (
        peak_level > 100.0 * non_peak)
    best = torch.argmax(torch.where(strong, peak_level, -1.0), dim=1)
    has_strong = torch.any(strong, dim=1)
    peak_band = torch.where(has_strong, take(peak_bins, best), peak_band)
    peak_counter = torch.where(has_strong, 0, peak_counter)
    return RenderSignalAnalyzerState(
        narrow_band_counters=counters.to(_I32),
        narrow_peak_band=peak_band.to(_I32),
        narrow_peak_counter=peak_counter.to(_I32),
    )


def poor_signal_excitation(state: RenderSignalAnalyzerState):
    """render_signal_analyzer.h:40-45: (B,) bool."""
    return torch.any(state.narrow_band_counters > 10, dim=1)


def narrow_zero_mask(state: RenderSignalAnalyzerState):
    """The (B, 65) bool mask MaskRegionsAroundNarrowBands zeroes
    (render_signal_analyzer.cc:134-151): +-2 bins around narrow bands."""
    trig = state.narrow_band_counters > 5  # (B, 63) for bins 1..63
    B = trig.shape[0]
    pad2 = torch.zeros((B, 2), dtype=torch.bool, device=trig.device)
    center = torch.cat([pad2, trig[:, 1:62], pad2], dim=1)  # bin-aligned
    padded = torch.cat([pad2, center, pad2], dim=1)  # (B, 69)
    zero = (padded[:, 0:65] | padded[:, 1:66] | padded[:, 2:67]
            | padded[:, 3:68] | padded[:, 4:69])
    bins = torch.arange(NUM_BINS, device=trig.device)
    return (zero | ((bins < 2) & trig[:, :1])
            | ((bins >= 63) & trig[:, 62:63]))


# ----------------------------------------------------------- adaptive filter


@dataclass
class FilterState:
    """AdaptiveFirFilter (adaptive_fir_filter.h)."""

    H: torch.Tensor  # (B, C_cap, P_max, C_ren, 65) complex64
    current_size: torch.Tensor  # (B,) int32
    target_size: torch.Tensor  # (B,) int32
    old_target_size: torch.Tensor  # (B,) int32
    size_change_counter: torch.Tensor  # (B,) int32
    partition_to_constrain: torch.Tensor  # (B,) int32

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def init_filter(num_capture, max_partitions, initial_partitions, num_render,
                batch: int, device) -> FilterState:
    def full(v):
        return torch.full((batch,), v, dtype=_I32, device=device)

    return FilterState(
        H=torch.zeros((batch, num_capture, max_partitions, num_render,
                       NUM_BINS), dtype=torch.complex64, device=device),
        current_size=full(initial_partitions),
        target_size=full(initial_partitions),
        old_target_size=full(initial_partitions),
        size_change_counter=full(0),
        partition_to_constrain=full(0),
    )


def _partition_mask(state: FilterState, lo, hi):
    """(B, P) bool: lo <= p < hi."""
    p = torch.arange(state.H.shape[2], device=state.H.device)
    return (p >= lo[:, None]) & (p < hi[:, None])


def set_size_partitions(state: FilterState, size: int, immediate: bool,
                        change_duration: int) -> FilterState:
    """AdaptiveFirFilter::SetSizePartitions (adaptive_fir_filter.cc)."""
    target = min(state.H.shape[2], size)
    t = torch.full_like(state.current_size, target)
    if immediate:
        mask = _partition_mask(state, state.current_size, t)
        return state.replace(
            H=torch.where(mask[:, None, :, None, None], 0.0, state.H),
            current_size=t, target_size=t, old_target_size=t.clone(),
            partition_to_constrain=torch.clamp(
                state.partition_to_constrain, max=target - 1),
            size_change_counter=torch.zeros_like(t),
        )
    return state.replace(target_size=t,
                         size_change_counter=torch.full_like(
                             t, change_duration))


def _update_size(state: FilterState, change_duration: int) -> FilterState:
    """AdaptiveFirFilter::UpdateSize."""
    counter = torch.clamp(state.size_change_counter - 1, min=0)
    in_transition = state.size_change_counter > 0
    factor = counter.to(torch.float32) / change_duration
    interp = (state.old_target_size.to(torch.float32) * factor
              + state.target_size.to(torch.float32) * (1.0 - factor)
              ).to(_I32)
    new_size = torch.where(in_transition, interp, state.target_size)
    mask = _partition_mask(state, state.current_size, new_size)
    return state.replace(
        H=torch.where(mask[:, None, :, None, None], 0.0, state.H),
        current_size=new_size,
        old_target_size=torch.where(in_transition, state.old_target_size,
                                    state.target_size),
        size_change_counter=counter.to(_I32),
        partition_to_constrain=torch.minimum(state.partition_to_constrain,
                                             new_size - 1),
    )


def apply_filter(state: FilterState, X_window: torch.Tensor):
    """aec3::ApplyFilter: S[c] = sum_{p < size, r} X[p, r] * H[c, p, r].

    X_window: (B, P_x, C_ren, 65) complex with P_x >= P_max. A shorter
    filter is zero-padded to P_x partitions, so that the refined and the
    coarse filter contract in one shape and one summation order: where the
    two filters agree on every partition the render window reaches, their
    outputs are bit-equal, as in the JAX twin (the comparisons between the
    two error energies depend on that tie). Returns (B, C_cap, 65)."""
    B, C, P = state.H.shape[:3]
    P_x = X_window.shape[1]
    H = state.H
    if P < P_x:
        H = torch.cat([H, torch.zeros((B, C, P_x - P) + H.shape[3:],
                                      dtype=H.dtype, device=H.device)], dim=2)
    p = torch.arange(P_x, device=H.device)
    mask = (p[None, :] < state.current_size[:, None]).to(torch.float32)
    Xm = X_window * mask[:, :, None, None]
    return torch.einsum("bprk,bcprk->bck", Xm, H)


def adapt_and_constrain_filter(state: FilterState, X_window, G,
                               impulse_response=None):
    """AdaptPartitions + Constrain(AndUpdateImpulseResponse): every active
    partition adapts, H[c, p, r] += conj(X[p, r]) G[c], and the one
    partition due this block is forced causal in the time domain.

    X_window: (B, P_max, C_ren, 65); G: (B, C_cap, 65); impulse_response
    (B, C_cap, P_max * 64) or None. Returns (state, impulse_response)."""
    B, C, P = state.H.shape[:3]
    mask = _partition_mask(state, torch.zeros_like(state.current_size),
                           state.current_size).to(torch.float32)
    Xm = torch.conj(X_window) * mask[:, :, None, None]  # (B, P, R, K)

    pc = state.partition_to_constrain
    pc_oh = torch.arange(P, device=pc.device)[None, :] == pc[:, None]
    H_pc = take(state.H.transpose(1, 2), pc)  # (B, C, R, K)
    X_pc = take(Xm, pc)  # (B, R, K)
    H_pc_new = H_pc + torch.einsum("brk,bck->bcrk", X_pc, G)

    h = afft.ifft_unnormalized(H_pc_new)  # (B, C, R, 128)
    h_head = h[..., :BLOCK_SIZE] * (1.0 / BLOCK_SIZE)
    new_H_pc = afft.fft(torch.cat([h_head, torch.zeros_like(h_head)], -1))

    H = torch.where(pc_oh[:, None, :, None, None], new_H_pc[:, :, None],
                    state.H + torch.einsum("bprk,bck->bcprk", Xm, G))

    new_ir = None
    if impulse_response is not None:
        seg = h_head[:, :, 0, :]  # (B, C, 64), channel 0 first
        for rc in range(1, h_head.shape[2]):
            cand = h_head[:, :, rc, :]
            seg = torch.where(torch.abs(seg) < torch.abs(cand), cand, seg)
        ir_blocks = impulse_response.reshape(B, C, P, BLOCK_SIZE)
        ir_blocks = torch.where(pc_oh[:, None, :, None], seg[:, :, None, :],
                                ir_blocks)
        new_ir = ir_blocks.reshape(impulse_response.shape)

    next_pc = torch.where(pc < state.current_size - 1, pc + 1, 0).to(_I32)
    return state.replace(H=H, partition_to_constrain=next_pc), new_ir


def compute_frequency_response(state: FilterState):
    """aec3::ComputeFrequencyResponse: (B, C_cap, P_max, 65), the max over
    render channels of |H|^2, zero beyond the current size."""
    H2 = torch.max(afft.spectrum(state.H), dim=3)[0]
    mask = _partition_mask(state, torch.zeros_like(state.current_size),
                           state.current_size)
    return torch.where(mask[:, None, :, None], H2, 0.0)


def compute_erl(H2):
    """aec3::ErlComputer: erl[k] = sum_p H2[p][k]."""
    return torch.sum(H2, dim=-2)


# ----------------------------------------------------------- update gains


@dataclass
class GainConfigState:
    """Interpolating filter-gain configuration (SetConfig transitions)."""

    current: torch.Tensor  # (B, K)
    target: torch.Tensor  # (B, K)
    old_target: torch.Tensor  # (B, K)
    counter: torch.Tensor  # (B,) int32

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def _refined_cfg_vec(c):
    return (c.leakage_converged, c.leakage_diverged, c.error_floor,
            c.error_ceil, c.noise_gate)


def _coarse_cfg_vec(c):
    return (c.rate, c.noise_gate)


def init_gain_config(vec, batch: int, device) -> GainConfigState:
    v = tile(vec, batch, torch.float32, device)
    return GainConfigState(current=v, target=v.clone(), old_target=v.clone(),
                           counter=torch.zeros((batch,), dtype=_I32,
                                               device=device))


def set_gain_config(state: GainConfigState, vec, immediate: bool,
                    change_duration: int) -> GainConfigState:
    B, dev = state.counter.shape[0], state.counter.device
    if immediate:
        return init_gain_config(vec, B, dev)
    return state.replace(target=tile(vec, B, torch.float32, dev),
                         counter=torch.full_like(state.counter,
                                                 change_duration))


def _update_gain_config(state: GainConfigState, change_duration: int):
    """RefinedFilterUpdateGain::UpdateCurrentConfig."""
    counter = torch.clamp(state.counter - 1, min=0)
    in_transition = (state.counter > 0)[:, None]
    still = (counter > 0)[:, None]
    factor = (counter.to(torch.float32) / change_duration)[:, None]
    interp = state.old_target * factor + state.target * (1.0 - factor)
    current = torch.where(in_transition,
                          torch.where(still, interp, state.target),
                          state.current)
    old_target = torch.where(in_transition & ~still, state.target,
                             state.old_target)
    return state.replace(current=current, old_target=old_target,
                         counter=counter.to(_I32))


@dataclass
class RefinedGainState:
    config: GainConfigState
    H_error: torch.Tensor  # (B, C, 65)
    poor_excitation_counter: torch.Tensor  # (B,) int32
    call_counter: torch.Tensor  # (B,) int32

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass
class CoarseGainState:
    config: GainConfigState
    poor_excitation_counter: torch.Tensor  # (B,) int32
    call_counter: torch.Tensor  # (B,) int32

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def init_refined_gain(config: EchoCanceller3Config, num_capture, batch,
                      device):
    return RefinedGainState(
        config=init_gain_config(
            _refined_cfg_vec(config.filter.refined_initial), batch, device),
        H_error=torch.full((batch, num_capture, NUM_BINS), H_ERROR_INITIAL,
                           dtype=torch.float32, device=device),
        poor_excitation_counter=torch.full(
            (batch,), POOR_EXCITATION_COUNTER_INITIAL, dtype=_I32,
            device=device),
        call_counter=torch.zeros((batch,), dtype=_I32, device=device),
    )


def init_coarse_gain(config: EchoCanceller3Config, batch, device):
    return CoarseGainState(
        config=init_gain_config(
            _coarse_cfg_vec(config.filter.coarse_initial), batch, device),
        poor_excitation_counter=torch.zeros((batch,), dtype=_I32,
                                            device=device),
        call_counter=torch.zeros((batch,), dtype=_I32, device=device),
    )


def refined_gain_compute(config, state: RefinedGainState, narrow_mask,
                         poor_excitation, X2, E_refined, E2_refined,
                         E2_coarse, erl, size_partitions, saturated_capture,
                         disallow_leakage_diverged):
    """RefinedFilterUpdateGain::Compute (refined_filter_update_gain.cc:
    80-150). narrow_mask (B, 65), poor_excitation (B,), X2 (B, 65),
    E_refined (B, C, 65) complex, E2_*/erl (B, C, 65), size_partitions and
    saturated_capture (B,), disallow_leakage_diverged (B, C).

    Returns (state, G (B, C, 65) complex)."""
    cc = _update_gain_config(state.config,
                             config.filter.config_change_duration_blocks)
    cur = cc.current
    leakage_converged, leakage_diverged = cur[:, 0:1, None], cur[:, 1:2, None]
    error_floor, error_ceil = cur[:, 2:3, None], cur[:, 3:4, None]
    noise_gate = cur[:, 4:5]
    call_counter = state.call_counter + 1
    poor = torch.where(poor_excitation, 0, state.poor_excitation_counter) + 1
    no_update = ((poor < size_partitions) | saturated_capture
                 | (call_counter <= size_partitions))[:, None, None]

    sizef = size_partitions.to(torch.float32)[:, None, None]
    X2c = X2[:, None, :]
    mu = torch.where(
        (X2 >= noise_gate)[:, None, :],
        state.H_error / (0.5 * state.H_error * X2c + sizef * E2_refined),
        0.0)
    mu = torch.where(narrow_mask[:, None, :], 0.0, mu)
    mu = torch.where(no_update, 0.0, mu)

    H_error = state.H_error - 0.5 * mu * X2c * state.H_error
    G = torch.where(no_update, 0.0, mu * E_refined)

    leak = torch.where(
        (E2_refined <= E2_coarse) | disallow_leakage_diverged[:, :, None],
        leakage_converged, leakage_diverged)
    H_error = H_error + leak * erl
    H_error = torch.minimum(torch.maximum(H_error, error_floor), error_ceil)
    return (
        state.replace(config=cc, H_error=H_error,
                      poor_excitation_counter=poor.to(_I32),
                      call_counter=call_counter.to(_I32)),
        G,
    )


def coarse_gain_compute(config, state: CoarseGainState, narrow_mask,
                        poor_excitation, X2, E_coarse, size_partitions,
                        saturated_capture):
    """CoarseFilterUpdateGain::Compute (coarse_filter_update_gain.cc:30-78)."""
    cc = _update_gain_config(state.config,
                             config.filter.config_change_duration_blocks)
    rate, noise_gate = cc.current[:, 0:1], cc.current[:, 1:2]
    call_counter = state.call_counter + 1
    poor = torch.where(poor_excitation, 0, state.poor_excitation_counter) + 1
    no_update = ((poor < size_partitions) | saturated_capture
                 | (call_counter <= size_partitions))[:, None, None]
    mu = torch.where(X2 > noise_gate, rate / torch.clamp(X2, min=1e-30), 0.0)
    mu = torch.where(narrow_mask, 0.0, mu)
    G = torch.where(no_update, 0.0, mu[:, None, :] * E_coarse)
    return (
        state.replace(config=cc, poor_excitation_counter=poor.to(_I32),
                      call_counter=call_counter.to(_I32)),
        G,
    )


# ----------------------------------------------------------- subtractor


@dataclass
class SubtractorState:
    refined: FilterState
    coarse: FilterState
    refined_gain: RefinedGainState
    coarse_gain: CoarseGainState
    # FilterMisadjustmentEstimator (subtractor.h:95-128) per capture channel.
    mis_e2_acum: torch.Tensor  # (B, C)
    mis_y2_acum: torch.Tensor  # (B, C)
    mis_blocks_acum: torch.Tensor  # (B, C) int32
    mis_inv: torch.Tensor  # (B, C)
    mis_overhang: torch.Tensor  # (B, C) int32
    poor_coarse_filter_counters: torch.Tensor  # (B, C) int32
    coarse_filter_reset_hangover: torch.Tensor  # (B, C) int32
    refined_frequency_responses: torch.Tensor  # (B, C, P_max, 65)
    refined_impulse_responses: torch.Tensor  # (B, C, P_max * 64)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def init_state(config: EchoCanceller3Config, num_render: int,
               num_capture: int, batch: int, device) -> SubtractorState:
    p_refined = max(config.filter.refined.length_blocks,
                    config.filter.refined_initial.length_blocks)
    p_coarse = max(config.filter.coarse.length_blocks,
                   config.filter.coarse_initial.length_blocks)
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=_I32, device=device)
    c = (batch, num_capture)
    return SubtractorState(
        refined=init_filter(num_capture, p_refined,
                            config.filter.refined_initial.length_blocks,
                            num_render, batch, device),
        coarse=init_filter(num_capture, p_coarse,
                           config.filter.coarse_initial.length_blocks,
                           num_render, batch, device),
        refined_gain=init_refined_gain(config, num_capture, batch, device),
        coarse_gain=init_coarse_gain(config, batch, device),
        mis_e2_acum=torch.zeros(c, **f32),
        mis_y2_acum=torch.zeros(c, **f32),
        mis_blocks_acum=torch.zeros(c, **i32),
        mis_inv=torch.zeros(c, **f32),
        mis_overhang=torch.zeros(c, **i32),
        poor_coarse_filter_counters=torch.zeros(c, **i32),
        coarse_filter_reset_hangover=torch.zeros(c, **i32),
        refined_frequency_responses=torch.zeros(c + (p_refined, NUM_BINS),
                                                **f32),
        refined_impulse_responses=torch.zeros(c + (p_refined * BLOCK_SIZE,),
                                              **f32),
    )


def exit_initial_state(config: EchoCanceller3Config,
                       state: SubtractorState) -> SubtractorState:
    """Subtractor::ExitInitialState (subtractor.cc:176-186)."""
    d = config.filter.config_change_duration_blocks
    return state.replace(
        refined_gain=state.refined_gain.replace(config=set_gain_config(
            state.refined_gain.config,
            _refined_cfg_vec(config.filter.refined), False, d)),
        coarse_gain=state.coarse_gain.replace(config=set_gain_config(
            state.coarse_gain.config,
            _coarse_cfg_vec(config.filter.coarse), False, d)),
        refined=set_size_partitions(
            state.refined, config.filter.refined.length_blocks, False, d),
        coarse=set_size_partitions(
            state.coarse, config.filter.coarse.length_blocks, False, d),
    )


def handle_echo_path_change(config: EchoCanceller3Config,
                            state: SubtractorState,
                            delay_change: torch.Tensor) -> SubtractorState:
    """Subtractor::HandleEchoPathChange (subtractor.cc:146-174): a delay
    change resets both filters and gains; a gain change alone changes
    nothing here."""
    d = config.filter.config_change_duration_blocks
    B, dev = delay_change.shape[0], delay_change.device
    s = state
    reset = s.replace(
        refined=set_size_partitions(
            s.refined.replace(H=torch.zeros_like(s.refined.H)),
            config.filter.refined_initial.length_blocks, True, d),
        coarse=set_size_partitions(
            s.coarse.replace(H=torch.zeros_like(s.coarse.H)),
            config.filter.coarse_initial.length_blocks, True, d),
        refined_gain=init_refined_gain(config, s.refined_gain.H_error.shape[1],
                                       B, dev),
        coarse_gain=init_coarse_gain(config, B, dev),
    )
    return tree_where(delay_change, reset, state)


def _prediction_error(S, y):
    """PredictionError (subtractor.cc:41-57). S (B, C, 65), y (B, C, 64)."""
    s = afft.ifft_unnormalized(S)[..., BLOCK_SIZE:] * (1.0 / BLOCK_SIZE)
    return y - s, s


def process(config: EchoCanceller3Config, state: SubtractorState,
            X_window, X2_refined, X2_coarse, y,
            analyzer: RenderSignalAnalyzerState, saturated_capture):
    """Subtractor::Process (subtractor.cc:188-321) for one block, the
    per-block path's form (the JAX twin's ``process``): X_window (B, P,
    C_ren, 65) complex with at least max(P_refined, P_coarse) rows, the
    spectral sums X2_refined and X2_coarse (B, 65) over the active
    partitions, y (B, C_cap, 64), the analyzer's state after this block's
    update and saturated_capture (B,). Returns (state, outputs dict)."""
    return _process_masked(
        config, state, X_window, X2_refined, X2_coarse, y,
        narrow_zero_mask(analyzer), poor_signal_excitation(analyzer),
        saturated_capture)


def _process_masked(config: EchoCanceller3Config, state: SubtractorState,
                    X_window, X2_refined, X2_coarse, y, narrow_mask,
                    poor_excitation, saturated_capture):
    """Subtractor::Process (subtractor.cc:188-321) with the analyzer inputs
    precomputed, the body of the JAX twin's ``process_masked``. X_window
    (B, P, C_ren, 65) carries at least max(P_refined, P_coarse) rows; y
    (B, C_cap, 64). Returns (state, outputs dict)."""
    p_r = state.refined.H.shape[2]
    p_c = state.coarse.H.shape[2]
    S_refined = apply_filter(state.refined, X_window)
    e_refined, s_refined = _prediction_error(S_refined, y)
    S_coarse = apply_filter(state.coarse, X_window)
    e_coarse, s_coarse = _prediction_error(S_coarse, y)

    y2 = torch.sum(y * y, dim=-1)
    e2_refined = torch.sum(e_refined * e_refined, dim=-1)
    e2_coarse = torch.sum(e_coarse * e_coarse, dim=-1)
    s2_refined = torch.sum(s_refined * s_refined, dim=-1)
    s_refined_max_abs = torch.max(torch.abs(s_refined), dim=-1)[0]
    s_coarse_max_abs = torch.max(torch.abs(s_coarse), dim=-1)[0]

    # Filter misadjustment estimation (subtractor.cc:324-357).
    e2a = state.mis_e2_acum + e2_refined
    y2a = state.mis_y2_acum + y2
    nblk = state.mis_blocks_acum + 1
    window_done = nblk == 4
    active = y2a > 4 * 200.0 ** 2 * BLOCK_SIZE
    update_val = e2a / torch.clamp(y2a, min=1e-30)
    done_active = window_done & active
    overhang = torch.where(
        done_active & (e2a > 4 * 7500.0 ** 2 * BLOCK_SIZE), 4,
        torch.clamp(state.mis_overhang - done_active.to(_I32), min=0))
    take_upd = done_active & ((update_val < state.mis_inv) | (overhang > 0))
    mis_inv = torch.where(
        take_upd, state.mis_inv + 0.1 * (update_val - state.mis_inv),
        state.mis_inv)
    e2a = torch.where(window_done, 0.0, e2a)
    y2a = torch.where(window_done, 0.0, y2a)
    nblk = torch.where(window_done, 0, nblk)

    adjust = mis_inv > 10.0  # (B, C)
    scale = torch.where(
        adjust, 2.0 / torch.sqrt(torch.clamp(mis_inv, min=1e-10)), 1.0)
    refined_H = state.refined.H * scale[:, :, None, None, None]
    impulse = state.refined_impulse_responses * scale[:, :, None]
    s_refined = s_refined * scale[:, :, None]
    e_refined = y - s_refined
    mis_inv = torch.where(adjust, 0.0, mis_inv)
    overhang = torch.where(adjust, 0, overhang)
    e2a = torch.where(adjust, 0.0, e2a)
    y2a = torch.where(adjust, 0.0, y2a)
    nblk = torch.where(adjust, 0, nblk)
    state = state.replace(
        refined=state.refined.replace(H=refined_H),
        refined_impulse_responses=impulse,
        mis_e2_acum=e2a, mis_y2_acum=y2a, mis_blocks_acum=nblk.to(_I32),
        mis_inv=mis_inv, mis_overhang=overhang.to(_I32),
    )

    # Error FFTs and spectra.
    E_refined = afft.zero_padded_fft(e_refined, "hanning")
    E_coarse = afft.zero_padded_fft(e_coarse, "hanning")
    E2_refined = afft.spectrum(E_refined)
    E2_coarse = afft.spectrum(E_coarse)

    # Refined filter update; adjusted channels get zero gain
    # (subtractor.cc:268-273).
    erl = compute_erl(state.refined_frequency_responses)
    new_rg, G_refined = refined_gain_compute(
        config, state.refined_gain, narrow_mask, poor_excitation,
        X2_refined, E_refined, E2_refined, E2_coarse, erl,
        state.refined.current_size, saturated_capture,
        state.coarse_filter_reset_hangover > 0)
    G_refined = torch.where(adjust[:, :, None], 0.0, G_refined)

    refined = _update_size(state.refined,
                           config.filter.config_change_duration_blocks)
    refined, impulse = adapt_and_constrain_filter(
        refined, X_window[:, :p_r], G_refined,
        state.refined_impulse_responses)
    freq_resp = compute_frequency_response(refined)

    # Coarse filter update (per capture channel, subtractor.cc:282-311).
    poor_counters = torch.where(e2_refined < e2_coarse,
                                state.poor_coarse_filter_counters + 1, 0)
    reset_coarse = poor_counters >= 5  # (B, C)
    poor_counters = torch.where(reset_coarse, 0, poor_counters)

    coarse = _update_size(state.coarse,
                          config.filter.config_change_duration_blocks)
    # SetFilter from refined on reset (subtractor.cc:289-301).
    if p_c <= p_r:
        refined_as_coarse = refined.H[:, :, :p_c]
    else:
        pad = torch.zeros(refined.H.shape[:2] + (p_c - p_r,)
                          + refined.H.shape[3:], dtype=refined.H.dtype,
                          device=refined.H.device)
        refined_as_coarse = torch.cat([refined.H, pad], dim=2)
    coarse = coarse.replace(H=torch.where(
        reset_coarse[:, :, None, None, None], refined_as_coarse, coarse.H))
    hangover = torch.where(
        reset_coarse, config.filter.coarse_reset_hangover_blocks,
        torch.clamp(state.coarse_filter_reset_hangover - 1, min=0))
    E_for_coarse = torch.where(reset_coarse[:, :, None], E_refined, E_coarse)
    new_cg, G_coarse = coarse_gain_compute(
        config, state.coarse_gain, narrow_mask, poor_excitation, X2_coarse,
        E_for_coarse, coarse.current_size, saturated_capture)
    coarse, _ = adapt_and_constrain_filter(coarse, X_window[:, :p_c],
                                           G_coarse)

    state = state.replace(
        refined=refined,
        coarse=coarse,
        refined_gain=new_rg,
        coarse_gain=new_cg,
        poor_coarse_filter_counters=poor_counters.to(_I32),
        coarse_filter_reset_hangover=hangover.to(_I32),
        refined_frequency_responses=freq_resp,
        refined_impulse_responses=impulse,
    )
    outputs = dict(
        s_refined=s_refined, s_coarse=s_coarse,
        e_refined=e_refined, e_coarse=e_coarse,
        E_refined=E_refined, E2_refined=E2_refined, E2_coarse=E2_coarse,
        y2=y2, e2_refined=e2_refined, e2_coarse=e2_coarse,
        s2_refined=s2_refined,
        s2_coarse=torch.sum(s_coarse * s_coarse, dim=-1),
        s_refined_max_abs=s_refined_max_abs,
        s_coarse_max_abs=s_coarse_max_abs,
    )
    return state, outputs


def process_pair(config: EchoCanceller3Config, state: SubtractorState,
                 X_windows, spec_wins, ys, narrow_masks, poor_excitations,
                 delay_changes, transitions, saturated_capture):
    """All subtractor work of one frame's 2-3 capture blocks, given the
    per-block inputs hoisted ahead of the block loop (the JAX twin's
    ``process_pair``, subtractor.py:916). Lists of per-block tensors:
    X_windows (B, P, C_ren, 65) complex, spec_wins (B, P, C_ren, 65), ys
    (B, C_cap, 64), narrow_masks (B, 65), poor_excitations, delay_changes
    and transitions (B,) bool. Returns (state, [outputs dict per block])."""
    outs = []
    for k in range(len(ys)):
        # Reference order (echo_remover.cc:317-348): HandleEchoPathChange,
        # then the initial-state transition.
        state = handle_echo_path_change(config, state, delay_changes[k])
        state = tree_where(transitions[k], exit_initial_state(config, state),
                           state)
        pidx = torch.arange(spec_wins[k].shape[1], device=ys[k].device)

        def masked_sum(size):
            keep = (pidx[None, :] < size[:, None])[:, :, None, None]
            return torch.sum(torch.where(keep, spec_wins[k], 0.0),
                             dim=(1, 2))

        state, out = _process_masked(
            config, state, X_windows[k],
            masked_sum(state.refined.current_size),
            masked_sum(state.coarse.current_size), ys[k], narrow_masks[k],
            poor_excitations[k], saturated_capture)
        out["refined_frequency_responses"] = state.refined_frequency_responses
        out["refined_impulse_responses"] = state.refined_impulse_responses
        out["refined_current_size"] = state.refined.current_size
        outs.append(out)
    return state, outs

