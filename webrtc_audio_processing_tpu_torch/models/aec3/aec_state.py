"""AEC3 adaptive state tracking.

Port of ``webrtc_audio_processing_tpu/models/aec3/aec_state.py``
(reference: aec3/aec_state.cc with subtractor_output_analyzer.cc,
filter_analyzer.cc, transparent_mode.cc [the legacy default],
erle_estimator.cc, subband_erle_estimator.cc, fullband_erle_estimator.cc,
erl_estimator.cc, reverb_model.cc, reverb_frequency_response.cc and
reverb_model_estimator.cc). Every per-stream scalar of the JAX twin is a
(B,) tensor here, every per-channel vector (B, C).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch

from webrtc_audio_processing_tpu_torch.models.aec3 import (
    echo_audibility as ea,
    render_buffer as rb,
    reverb_decay_estimator as rde,
    signal_dependent_erle as sde,
)
from webrtc_audio_processing_tpu_torch.models.aec3.config import (
    EchoCanceller3Config,
)
from webrtc_audio_processing_tpu_torch.models.aec3.fast_log2 import (
    fast_approx_log2,
)
from webrtc_audio_processing_tpu_torch.ops.batch import take, tree_where

NUM_BINS = 65
BLOCK_SIZE = 64
BLOCKS_PER_SECOND = 250
X2_BAND_ENERGY_THRESHOLD = 44015068.0
POINTS_TO_ACCUMULATE = 6
BLOCKS_TO_HOLD_ERLE = 100
BLOCKS_FOR_ONSET_DETECTION = BLOCKS_TO_HOLD_ERLE + 150
MIN_ERL = 0.01
MAX_ERL = 1000.0
_I32 = torch.int32


def _full(shape, value, dtype, device):
    return torch.full(shape, value, dtype=dtype, device=device)


# -------------------------------------------------------- subtractor analyzer


@dataclass
class SubtractorOutputAnalyzerState:
    filters_converged: torch.Tensor  # (B, C) bool


def analyze_subtractor_output(y2, e2_refined, e2_coarse):
    """SubtractorOutputAnalyzer::Update (subtractor_output_analyzer.cc:30-63)
    on (B, C) energies. Returns (state, any_converged, any_coarse_converged,
    all_diverged), the last three (B,)."""
    thr = 50.0 * 50.0 * BLOCK_SIZE
    thr_low = 20.0 * 20.0 * BLOCK_SIZE
    refined_conv = (e2_refined < 0.5 * y2) & (y2 > thr)
    coarse_strict = (e2_coarse < 0.05 * y2) & (y2 > thr)
    coarse_relaxed = (e2_coarse < 0.3 * y2) & (y2 > thr_low)
    diverged = (torch.minimum(e2_refined, e2_coarse) > 1.5 * y2) & (
        y2 > 30.0 * 30.0 * BLOCK_SIZE)
    converged = refined_conv | coarse_strict
    return (SubtractorOutputAnalyzerState(filters_converged=converged),
            torch.any(converged, dim=1), torch.any(coarse_relaxed, dim=1),
            torch.all(diverged, dim=1))


# ------------------------------------------------------------ filter analyzer


@dataclass
class FilterAnalyzerState:
    """FilterAnalyzer (filter_analyzer.h), per capture channel."""

    h_highpass: torch.Tensor  # (B, C, P_max * 64)
    peak_index: torch.Tensor  # (B, C) int32
    gain: torch.Tensor  # (B, C)
    consistent_estimate: torch.Tensor  # (B, C) bool
    significant_peak: torch.Tensor  # (B, C) bool
    filter_floor_accum: torch.Tensor  # (B, C)
    filter_secondary_peak: torch.Tensor  # (B, C)
    filter_floor_low_limit: torch.Tensor  # (B, C) int32
    filter_floor_high_limit: torch.Tensor  # (B, C) int32
    consistent_estimate_counter: torch.Tensor  # (B, C) int32
    consistent_delay_reference: torch.Tensor  # (B, C) int32
    region_start: torch.Tensor  # (B,) int32
    region_end: torch.Tensor  # (B,) int32
    blocks_since_reset: torch.Tensor  # (B,) int32
    filter_delays_blocks: torch.Tensor  # (B, C) int32
    min_filter_delay_blocks: torch.Tensor  # (B,) int32

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def init_filter_analyzer(config: EchoCanceller3Config, num_capture, p_max,
                         batch, device) -> FilterAnalyzerState:
    bc = (batch, num_capture)
    f32 = torch.float32
    return FilterAnalyzerState(
        h_highpass=_full(bc + (p_max * BLOCK_SIZE,), 0.0, f32, device),
        peak_index=_full(bc, 0, _I32, device),
        gain=_full(bc, config.ep_strength.default_gain, f32, device),
        consistent_estimate=_full(bc, False, torch.bool, device),
        significant_peak=_full(bc, False, torch.bool, device),
        filter_floor_accum=_full(bc, 0.0, f32, device),
        filter_secondary_peak=_full(bc, 0.0, f32, device),
        filter_floor_low_limit=_full(bc, 0, _I32, device),
        filter_floor_high_limit=_full(bc, 0, _I32, device),
        consistent_estimate_counter=_full(bc, 0, _I32, device),
        consistent_delay_reference=_full(bc, -10, _I32, device),
        region_start=_full((batch,), 0, _I32, device),
        region_end=_full((batch,), 0, _I32, device),
        blocks_since_reset=_full((batch,), 0, _I32, device),
        filter_delays_blocks=_full(bc, 0, _I32, device),
        min_filter_delay_blocks=_full((batch,), 0, _I32, device),
    )


_HP_KERNEL = (0.7929742, -0.36072128, -0.47047766)


def filter_analyzer_update(config, state: FilterAnalyzerState,
                           impulse_responses, filter_size_samples,
                           blocks_win):
    """FilterAnalyzer::Update (filter_analyzer.cc:77-101) with the cyclic
    64-sample analysis region. impulse_responses (B, C, T),
    filter_size_samples (B,), blocks_win (B, W, bands, 64, C_ren) the
    delay-aligned lookback window. Returns (state, any_consistent (B,),
    max_gain (B,))."""
    n_taps = state.h_highpass.shape[-1]
    dev = impulse_responses.device
    taps = torch.arange(n_taps, device=dev)
    blocks_since_reset = state.blocks_since_reset + 1
    fs = filter_size_samples

    # SetRegionToAnalyze (:180-190).
    start = torch.where(state.region_end >= fs - 1, 0, state.region_end + 1)
    end = torch.minimum(start + BLOCK_SIZE - 1, fs - 1)
    in_region = ((taps >= start[:, None]) & (taps <= end[:, None]))[:, None]

    # PreProcessFilters (:134-160): causal 3-tap high-pass in the region.
    h = impulse_responses
    z1 = torch.zeros_like(h[..., :1])
    hp = (h * _HP_KERNEL[0]
          + torch.cat([z1, h[..., :-1]], dim=-1) * _HP_KERNEL[1]
          + torch.cat([z1, z1, h[..., :-2]], dim=-1) * _HP_KERNEL[2])
    hp = torch.where(taps < torch.clamp(start, min=2)[:, None, None], 0.0, hp)
    h_highpass = torch.where(in_region, hp, state.h_highpass)

    # FindPeakIndex within the region, seeded with the previous peak.
    prev_peak = torch.clamp(state.peak_index, max=n_taps - 1)
    h2 = h_highpass ** 2
    prev_val = torch.gather(h2, 2, prev_peak[..., None].long())[..., 0]
    region_vals = torch.where(in_region, h2, -1.0)
    region_max, region_arg = torch.max(region_vals, dim=-1)
    peak_index = torch.where(region_max > prev_val, region_arg,
                             prev_peak).to(_I32)
    filter_delays_blocks = peak_index >> 6

    # ConsistentFilterDetector (:196-262).
    at_start = (start == 0)[:, None]
    floor_low = torch.where(
        at_start, torch.where(peak_index < 64, 0, peak_index - 64),
        state.filter_floor_low_limit)
    floor_high = torch.where(
        at_start, torch.where(peak_index > (fs - 129)[:, None], 0,
                              peak_index + 128),
        state.filter_floor_high_limit)
    accum0 = torch.where(at_start, 0.0, state.filter_floor_accum)
    sec0 = torch.where(at_start, 0.0, state.filter_secondary_peak)

    abs_h = torch.abs(h_highpass)
    in_floor = in_region & ((taps < floor_low[..., None])
                            | (taps >= floor_high[..., None]))
    floor_vals = torch.where(in_floor, abs_h, 0.0)
    accum = accum0 + torch.sum(floor_vals, dim=-1)
    sec = torch.maximum(sec0, torch.max(floor_vals, dim=-1)[0])

    finalize = (end == fs - 1)[:, None]
    floor_count = (floor_low + fs[:, None] - floor_high).to(torch.float32)
    filter_floor = accum / torch.clamp(floor_count, min=1.0)
    abs_peak = torch.gather(abs_h, 2, peak_index[..., None].long())[..., 0]
    new_significant = (abs_peak > 10.0 * filter_floor) & (abs_peak > 2.0 * sec)
    significant = torch.where(finalize, new_significant,
                              state.significant_peak)

    # Active render at the delay-aligned block.
    x_aligned = take(blocks_win, filter_delays_blocks)[:, :, 0]
    x_energy = torch.sum(x_aligned ** 2, dim=2)  # (B, C, C_ren)
    active = torch.any(
        x_energy > config.render_levels.active_render_limit ** 2 * BLOCK_SIZE,
        dim=-1)

    same_ref = state.consistent_delay_reference == filter_delays_blocks
    counter = torch.where(
        significant,
        torch.where(same_ref,
                    state.consistent_estimate_counter + active.to(_I32), 0),
        state.consistent_estimate_counter)
    delay_ref = torch.where(significant & ~same_ref, filter_delays_blocks,
                            state.consistent_delay_reference)
    consistent = counter > 1.5 * BLOCKS_PER_SECOND

    # UpdateFilterGain (:104-127).
    suff_time = (blocks_since_reset > 5 * BLOCKS_PER_SECOND)[:, None]
    gain = torch.where(
        suff_time & consistent, abs_peak,
        torch.where(state.gain != 0.0, torch.maximum(state.gain, abs_peak),
                    state.gain))
    if config.ep_strength.bounded_erl:
        gain = torch.where(gain != 0.0, torch.clamp(gain, min=0.01), gain)

    new_state = state.replace(
        h_highpass=h_highpass,
        peak_index=peak_index,
        gain=gain,
        consistent_estimate=consistent,
        significant_peak=significant,
        filter_floor_accum=accum,
        filter_secondary_peak=sec,
        filter_floor_low_limit=floor_low.to(_I32),
        filter_floor_high_limit=floor_high.to(_I32),
        consistent_estimate_counter=counter.to(_I32),
        consistent_delay_reference=delay_ref.to(_I32),
        region_start=start.to(_I32),
        region_end=end.to(_I32),
        blocks_since_reset=blocks_since_reset.to(_I32),
        filter_delays_blocks=filter_delays_blocks,
        min_filter_delay_blocks=torch.min(filter_delays_blocks, dim=1)[0],
    )
    return (new_state, torch.any(consistent, dim=1),
            torch.max(gain, dim=1)[0])


def reset_filter_analyzer(config, state: FilterAnalyzerState):
    B, C = state.peak_index.shape
    fresh = init_filter_analyzer(config, C, state.h_highpass.shape[-1] // 64,
                                 B, state.peak_index.device)
    return fresh.replace(h_highpass=state.h_highpass)


# ------------------------------------------------------------ transparent mode


@dataclass
class TransparentModeState:
    """LegacyTransparentModeImpl (transparent_mode.cc:141-224), (B,) each."""

    capture_block_counter: torch.Tensor
    active: torch.Tensor
    active_blocks_since_sane_filter: torch.Tensor
    sane_filter_observed: torch.Tensor
    finite_erl_recently_detected: torch.Tensor
    non_converged_sequence_size: torch.Tensor
    diverged_sequence_size: torch.Tensor
    active_non_converged_sequence_size: torch.Tensor
    num_converged_blocks: torch.Tensor
    recent_convergence_during_activity: torch.Tensor
    strong_not_saturated_render_blocks: torch.Tensor


def init_transparent_mode(batch: int, device) -> TransparentModeState:
    def i(v):
        return _full((batch,), v, _I32, device)

    def b(v):
        return _full((batch,), v, torch.bool, device)

    return TransparentModeState(
        capture_block_counter=i(0), active=b(False),
        active_blocks_since_sane_filter=i(10000),
        sane_filter_observed=b(False), finite_erl_recently_detected=b(False),
        non_converged_sequence_size=i(10000), diverged_sequence_size=i(0),
        active_non_converged_sequence_size=i(0), num_converged_blocks=i(0),
        recent_convergence_during_activity=b(False),
        strong_not_saturated_render_blocks=i(0),
    )


def transparent_mode_update(state: TransparentModeState, filter_delay_blocks,
                            any_filter_consistent, any_filter_converged,
                            all_filters_diverged, active_render,
                            saturated_capture):
    """LegacyTransparentModeImpl::Update (transparent_mode.cc:158-219)."""
    active_i = active_render.to(_I32)
    counter = state.capture_block_counter + 1
    strong = state.strong_not_saturated_render_blocks + (
        active_render & ~saturated_capture).to(_I32)
    sane_now = any_filter_consistent & (filter_delay_blocks < 5)
    sane_observed = state.sane_filter_observed | sane_now
    active_since_sane = torch.where(
        sane_now, 0, state.active_blocks_since_sane_filter + active_i)
    sane_recent = torch.where(~sane_observed,
                              counter <= 5 * BLOCKS_PER_SECOND,
                              active_since_sane <= 30 * BLOCKS_PER_SECOND)
    conv = any_filter_converged
    recent_conv = conv | state.recent_convergence_during_activity
    active_nc = torch.where(
        conv, 0, state.active_non_converged_sequence_size + active_i)
    recent_conv = recent_conv & ~(~conv & (active_nc
                                           > 60 * BLOCKS_PER_SECOND))
    nc_size = torch.where(conv, 0, state.non_converged_sequence_size + 1)
    num_conv = torch.where(
        conv, state.num_converged_blocks + 1,
        torch.where(nc_size > 20 * BLOCKS_PER_SECOND, 0,
                    state.num_converged_blocks))
    div_size = torch.where(all_filters_diverged,
                           state.diverged_sequence_size + 1, 0)
    nc_size = torch.where(div_size >= 60, 10000, nc_size)
    finite_erl = state.finite_erl_recently_detected & ~(
        active_nc > 60 * BLOCKS_PER_SECOND)
    finite_erl = finite_erl | (num_conv > 50)
    should_have_converged = strong > 6 * BLOCKS_PER_SECOND
    active = ~finite_erl & ~(sane_recent & recent_conv) & should_have_converged
    return TransparentModeState(
        capture_block_counter=counter.to(_I32),
        active=active,
        active_blocks_since_sane_filter=active_since_sane.to(_I32),
        sane_filter_observed=sane_observed,
        finite_erl_recently_detected=finite_erl,
        non_converged_sequence_size=nc_size.to(_I32),
        diverged_sequence_size=div_size.to(_I32),
        active_non_converged_sequence_size=active_nc.to(_I32),
        num_converged_blocks=num_conv.to(_I32),
        recent_convergence_during_activity=recent_conv,
        strong_not_saturated_render_blocks=strong.to(_I32),
    )


# -------------------------------------------------------------- ERLE / ERL


@dataclass
class SubbandErleState:
    """SubbandErleEstimator (subband_erle_estimator.h)."""

    erle: torch.Tensor  # (B, C, 65)
    erle_onset_compensated: torch.Tensor  # (B, C, 65)
    erle_unbounded: torch.Tensor  # (B, C, 65)
    erle_during_onsets: torch.Tensor  # (B, C, 65)
    coming_onset: torch.Tensor  # (B, C, 65) bool
    hold_counters: torch.Tensor  # (B, C, 65) int32
    accum_Y2: torch.Tensor  # (B, C, 65)
    accum_E2: torch.Tensor  # (B, C, 65)
    accum_low_render: torch.Tensor  # (B, C, 65) bool
    accum_points: torch.Tensor  # (B, C) int32

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass
class FullBandErleState:
    erle_time_domain_log2: torch.Tensor  # (B, C)
    hold_counters: torch.Tensor  # (B, C) int32
    erle_log2: torch.Tensor  # (B, C)
    erle_log2_valid: torch.Tensor  # (B, C) bool
    inst_quality: torch.Tensor  # (B, C)
    max_erle_log2: torch.Tensor  # (B, C)
    min_erle_log2: torch.Tensor  # (B, C)
    num_points: torch.Tensor  # (B, C) int32
    E2_acum: torch.Tensor  # (B, C)
    Y2_acum: torch.Tensor  # (B, C)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass
class ErleState:
    subband: SubbandErleState
    fullband: FullBandErleState
    blocks_since_reset: torch.Tensor  # (B,) int32
    # The signal-dependent estimator, only when erle.num_sections > 1.
    sd: sde.SignalDependentErleState | None = None

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass
class ErlState:
    erl: torch.Tensor  # (B, 65)
    hold_counters: torch.Tensor  # (B, 63) int32
    erl_time_domain: torch.Tensor  # (B,)
    hold_counter_time_domain: torch.Tensor  # (B,) int32
    blocks_since_reset: torch.Tensor  # (B,) int32

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def init_subband_erle(config, num_capture, batch, device) -> SubbandErleState:
    mn = config.erle.min
    s = (batch, num_capture, NUM_BINS)
    f32 = torch.float32
    return SubbandErleState(
        erle=_full(s, mn, f32, device),
        erle_onset_compensated=_full(s, mn, f32, device),
        erle_unbounded=_full(s, mn, f32, device),
        erle_during_onsets=_full(s, mn, f32, device),
        coming_onset=_full(s, True, torch.bool, device),
        hold_counters=_full(s, 0, _I32, device),
        accum_Y2=_full(s, 0.0, f32, device),
        accum_E2=_full(s, 0.0, f32, device),
        accum_low_render=_full(s, False, torch.bool, device),
        accum_points=_full(s[:2], 0, _I32, device),
    )


def init_fullband_erle(config, num_capture, batch,
                       device) -> FullBandErleState:
    min_log2 = math.log2(config.erle.min + 1e-3)
    s = (batch, num_capture)
    f32 = torch.float32
    return FullBandErleState(
        erle_time_domain_log2=_full(s, min_log2, f32, device),
        hold_counters=_full(s, 0, _I32, device),
        erle_log2=_full(s, 0.0, f32, device),
        erle_log2_valid=_full(s, False, torch.bool, device),
        inst_quality=_full(s, 0.0, f32, device),
        max_erle_log2=_full(s, -10.0, f32, device),
        min_erle_log2=_full(s, 33.0, f32, device),
        num_points=_full(s, 0, _I32, device),
        E2_acum=_full(s, 0.0, f32, device),
        Y2_acum=_full(s, 0.0, f32, device),
    )


def init_erle(config, num_capture, batch, device) -> ErleState:
    return ErleState(
        subband=init_subband_erle(config, num_capture, batch, device),
        fullband=init_fullband_erle(config, num_capture, batch, device),
        blocks_since_reset=_full((batch,), 0, _I32, device),
        sd=(sde.init_state(config, num_capture, batch, device)
            if config.erle.num_sections > 1 else None),
    )


def reset_erle(config, state: ErleState, delay_change: bool) -> ErleState:
    B, C = state.subband.accum_points.shape
    fresh = init_erle(config, C, B, state.blocks_since_reset.device)
    if not delay_change:
        fresh = fresh.replace(blocks_since_reset=state.blocks_since_reset)
    return fresh


def erle_arrays(config, state: ErleState):
    """(erle, erle_onset_compensated, erle_unbounded), each (B, C, 65), with
    the signal-dependent dispatch of erle_estimator.h:58-75."""
    if config.erle.num_sections > 1:
        sd = state.sd
        eoc = (sd.erle_onset_compensated if config.erle.onset_detection
               else sd.erle)
        return sd.erle, eoc, sd.erle
    sb = state.subband
    return sb.erle, sb.erle_onset_compensated, sb.erle_unbounded


def init_erl(batch, device) -> ErlState:
    return ErlState(
        erl=_full((batch, NUM_BINS), MAX_ERL, torch.float32, device),
        hold_counters=_full((batch, 63), 0, _I32, device),
        erl_time_domain=_full((batch,), MAX_ERL, torch.float32, device),
        hold_counter_time_domain=_full((batch,), 0, _I32, device),
        blocks_since_reset=_full((batch,), 0, _I32, device),
    )


def _max_erle_bands(config, device):
    return torch.cat([_full((32,), config.erle.max_l, torch.float32, device),
                      _full((33,), config.erle.max_h, torch.float32, device)])


def _subband_erle_update(config, st: SubbandErleState, X2_reverb, Y2, E2,
                         converged):
    """SubbandErleEstimator::Update (subband_erle_estimator.cc:80-110).
    X2_reverb (B, 65); Y2, E2 (B, C, 65); converged (B, C)."""
    dev = Y2.device
    max_erle = _max_erle_bands(config, dev)
    min_erle = config.erle.min
    conv = converged[..., None]

    # UpdateAccumulatedSpectra (:215-246).
    reset_acc = (converged & (st.accum_points == POINTS_TO_ACCUMULATE))[
        ..., None]
    aY2 = torch.where(reset_acc, 0.0, st.accum_Y2)
    aE2 = torch.where(reset_acc, 0.0, st.accum_E2)
    aLow = st.accum_low_render & ~reset_acc
    pts = torch.where(reset_acc[..., 0], 0, st.accum_points)
    aY2 = torch.where(conv, aY2 + Y2, aY2)
    aE2 = torch.where(conv, aE2 + E2, aE2)
    aLow = torch.where(
        conv, aLow | (X2_reverb[:, None, :] < X2_BAND_ENERGY_THRESHOLD), aLow)
    pts = torch.where(converged, pts + 1, pts)

    # UpdateBands (:113-177).
    do_band = (converged & (pts == POINTS_TO_ACCUMULATE))[..., None]
    bins = torch.arange(NUM_BINS, device=dev)
    interior = (bins >= 1) & (bins < 64)
    updated = (aE2 > 0.0) & do_band & interior
    new_erle = aY2 / torch.clamp(aE2, min=1e-30)

    onset_update = updated & ~aLow
    alpha_on = torch.where(new_erle < st.erle_during_onsets, 0.3, 0.15)
    erle_onsets = torch.where(
        onset_update & st.coming_onset,
        torch.minimum(torch.clamp(
            st.erle_during_onsets + alpha_on * (new_erle
                                                - st.erle_during_onsets),
            min=min_erle), max_erle),
        st.erle_during_onsets)
    coming_onset = st.coming_onset & ~onset_update
    hold = torch.where(onset_update, BLOCKS_FOR_ONSET_DETECTION,
                       st.hold_counters)

    def band_update(erle, cap):
        alpha = torch.where(new_erle < erle,
                            torch.where(aLow, 0.0, 0.1), 0.05)
        out = torch.minimum(torch.clamp(erle + alpha * (new_erle - erle),
                                        min=min_erle), cap)
        return torch.where(updated, out, erle)

    erle = band_update(st.erle, max_erle)
    erle_oc = band_update(st.erle_onset_compensated, max_erle)
    erle_unb = band_update(st.erle_unbounded,
                           torch.full_like(max_erle, 100000.0))

    # DecreaseErlePerBandForLowRenderSignals (:180-198).
    if config.erle.onset_detection:
        hold = hold - 1
        decay = hold <= (BLOCKS_FOR_ONSET_DETECTION - BLOCKS_TO_HOLD_ERLE)
        erle_oc = torch.where(decay & (erle_oc > erle_onsets),
                              torch.maximum(erle_onsets, 0.97 * erle_oc),
                              erle_oc)
        drained = decay & (hold <= 0)
        coming_onset = coming_onset | drained
        hold = torch.where(drained, 0, hold)

    def fix_edges(a):
        return torch.cat([a[..., 1:2], a[..., 1:64], a[..., 63:64]], dim=-1)

    return st.replace(
        erle=fix_edges(erle),
        erle_onset_compensated=fix_edges(erle_oc),
        erle_unbounded=fix_edges(erle_unb),
        erle_during_onsets=erle_onsets,
        coming_onset=coming_onset,
        hold_counters=hold.to(_I32),
        accum_Y2=aY2, accum_E2=aE2, accum_low_render=aLow,
        accum_points=pts.to(_I32),
    )


def _fullband_erle_update(config, st: FullBandErleState, X2_reverb, Y2, E2,
                          converged):
    """FullBandErleEstimator::Update (fullband_erle_estimator.cc:52-85)."""
    min_log2 = math.log2(config.erle.min + 1e-3)
    strong = torch.sum(X2_reverb, dim=-1) > X2_BAND_ENERGY_THRESHOLD * NUM_BINS
    do_acc = converged & strong[:, None]  # (B, C)

    E2a = st.E2_acum + torch.where(do_acc, torch.sum(E2, dim=-1), 0.0)
    Y2a = st.Y2_acum + torch.where(do_acc, torch.sum(Y2, dim=-1), 0.0)
    pts = st.num_points + do_acc.to(_I32)

    full = do_acc & (pts == POINTS_TO_ACCUMULATE)
    update = full & (E2a > 0.0)
    new_log2 = fast_approx_log2(Y2a / torch.clamp(E2a, min=1e-30) + 1e-3)
    erle_log2 = torch.where(update, new_log2, st.erle_log2)
    erle_valid = st.erle_log2_valid | update
    E2a = torch.where(full, 0.0, E2a)
    Y2a = torch.where(full, 0.0, Y2a)
    pts = torch.where(full, 0, pts)

    max_l2 = torch.where(update,
                         torch.maximum(st.max_erle_log2 - 0.0004, erle_log2),
                         st.max_erle_log2)
    min_l2 = torch.where(update,
                         torch.minimum(st.min_erle_log2 + 0.0004, erle_log2),
                         st.min_erle_log2)
    q = torch.where(max_l2 > min_l2,
                    (erle_log2 - min_l2) / torch.clamp(max_l2 - min_l2,
                                                       min=1e-10), 0.0)
    inst_q = torch.where(
        update,
        torch.where(q > st.inst_quality, q,
                    st.inst_quality + 0.07 * (q - st.inst_quality)),
        st.inst_quality)
    hold = torch.where(update, BLOCKS_TO_HOLD_ERLE, st.hold_counters)
    erle_td = torch.where(
        update,
        torch.clamp(st.erle_time_domain_log2
                    + 0.05 * (erle_log2 - st.erle_time_domain_log2),
                    min=min_log2),
        st.erle_time_domain_log2)
    hold = hold - 1
    reset_inst = hold == 0
    return st.replace(
        erle_time_domain_log2=erle_td,
        hold_counters=hold.to(_I32),
        erle_log2=erle_log2,
        erle_log2_valid=erle_valid & ~reset_inst,
        inst_quality=torch.where(reset_inst, 0.0, inst_q),
        max_erle_log2=max_l2,
        min_erle_log2=min_l2,
        num_points=torch.where(reset_inst, 0, pts).to(_I32),
        E2_acum=torch.where(reset_inst, 0.0, E2a),
        Y2_acum=torch.where(reset_inst, 0.0, Y2a),
    )


def erle_update(config, state: ErleState, X2_reverb, Y2, E2, converged,
                X2_by_delay=None, frequency_responses=None):
    """ErleEstimator::Update (erle_estimator.cc:47-77). X2_by_delay
    (B, num_blocks, 65) and frequency_responses (B, C, P, 65) feed the
    signal-dependent estimator (erle.num_sections > 1 only)."""
    blocks = state.blocks_since_reset + 1
    skip = blocks < 2 * BLOCKS_PER_SECOND
    conv = converged & ~skip[:, None]
    sub = tree_where(skip, state.subband,
                     _subband_erle_update(config, state.subband, X2_reverb,
                                          Y2, E2, conv))
    full = tree_where(skip, state.fullband,
                      _fullband_erle_update(config, state.fullband,
                                            X2_reverb, Y2, E2, conv))
    sd = state.sd
    if config.erle.num_sections > 1:
        sd = tree_where(skip, sd, sde.update(
            config, sd, X2_by_delay, frequency_responses, X2_reverb, Y2, E2,
            sub.erle, sub.erle_onset_compensated, conv))
    return state.replace(subband=sub, fullband=full,
                         blocks_since_reset=blocks.to(_I32), sd=sd)


def erl_update(state: ErlState, converged, X2_at_delay, Y2):
    """ErlEstimator::Update (erl_estimator.cc:39-135). converged (B, C),
    X2_at_delay (B, C_ren, 65), Y2 (B, C, 65)."""
    blocks = state.blocks_since_reset + 1
    skip = (blocks < 2 * BLOCKS_PER_SECOND) | ~torch.any(converged, dim=1)
    Y2_max = torch.max(torch.where(converged[..., None], Y2, -float("inf")),
                       dim=1)[0]
    Y2_max = torch.where(torch.isfinite(Y2_max), Y2_max, 0.0)
    X2_max = torch.max(X2_at_delay, dim=1)[0]

    kX2Min = X2_BAND_ENERGY_THRESHOLD
    bins = torch.arange(NUM_BINS, device=Y2.device)
    interior = (bins >= 1) & (bins < 64)
    new_erl = Y2_max / torch.clamp(X2_max, min=1e-30)
    decrease = interior & (X2_max > kX2Min) & (new_erl < state.erl)
    erl = torch.where(
        decrease,
        torch.clamp(state.erl + 0.1 * (new_erl - state.erl), min=MIN_ERL),
        state.erl)
    hold = torch.where(decrease[:, 1:64], 1000, state.hold_counters) - 1
    mid = torch.where(hold > 0, erl[:, 1:64],
                      torch.clamp(2.0 * erl[:, 1:64], max=MAX_ERL))
    erl = torch.cat([mid[:, :1], mid, mid[:, -1:]], dim=1)

    # Time-domain ERL (erl_estimator.cc:120-135).
    X2_tot = torch.sum(X2_max, dim=1)
    Y2_tot = torch.sum(Y2_max, dim=1)
    new_td = Y2_tot / torch.clamp(X2_tot, min=1e-30)
    dec_td = (X2_tot > kX2Min * NUM_BINS) & (new_td < state.erl_time_domain)
    erl_td = torch.where(
        dec_td,
        torch.clamp(state.erl_time_domain
                    + 0.1 * (new_td - state.erl_time_domain), min=MIN_ERL),
        state.erl_time_domain)
    hold_td = torch.where(dec_td, 1000, state.hold_counter_time_domain) - 1
    erl_td = torch.where(hold_td > 0, erl_td,
                         torch.clamp(2.0 * erl_td, max=MAX_ERL))
    new = ErlState(erl=erl, hold_counters=hold.to(_I32),
                   erl_time_domain=erl_td,
                   hold_counter_time_domain=hold_td.to(_I32),
                   blocks_since_reset=blocks.to(_I32))
    return tree_where(skip, state, new).replace(
        blocks_since_reset=blocks.to(_I32))


# ------------------------------------------------------------------ reverb


@dataclass
class ReverbModelState:
    reverb: torch.Tensor  # (B, 65)


def reverb_update(st: ReverbModelState, power_spectrum, scaling, decay):
    """ReverbModel::UpdateReverb and UpdateReverbNoFreqShaping
    (reverb_model.cc:30-55): ``scaling`` per bin (B, 65) or per stream
    (B, 1); decay (B,)."""
    d = decay[:, None]
    new = (st.reverb + power_spectrum * scaling) * d
    return ReverbModelState(reverb=torch.where(d > 0, new, st.reverb))


@dataclass
class ReverbFrequencyResponseState:
    average_decay: torch.Tensor  # (B, C)
    tail_response: torch.Tensor  # (B, C, 65)


def reverb_frequency_response_update(config, st, frequency_responses,
                                     filter_delays_blocks, quality,
                                     quality_valid, last_partition_index):
    """ReverbFrequencyResponse::Update (reverb_frequency_response.cc:52-96).
    frequency_responses (B, C, P, 65); filter_delays_blocks, quality and
    quality_valid (B, C); last_partition_index (B,)."""
    C = st.tail_response.shape[1]
    fr = frequency_responses
    tail = torch.gather(
        fr, 2, last_partition_index.long()[:, None, None, None].expand(
            -1, C, 1, NUM_BINS))[:, :, 0]
    direct = torch.gather(
        fr, 2, filter_delays_blocks.long()[:, :, None, None].expand(
            -1, -1, 1, NUM_BINS))[:, :, 0]
    direct_energy = torch.sum(direct[..., 1:], dim=-1)
    tail_energy = torch.sum(tail[..., 1:], dim=-1)
    avg_decay = torch.where(
        direct_energy > 0,
        tail_energy / torch.clamp(direct_energy, min=1e-30), 0.0)
    smoothing = 0.2 * quality
    new_avg = st.average_decay + smoothing * (avg_decay - st.average_decay)
    tail_resp = direct * new_avg[..., None]
    if config.ep_strength.use_conservative_tail_frequency_response:
        tail_resp = torch.maximum(tail, tail_resp)
    neigh = 0.5 * (tail_resp[..., :-2] + tail_resp[..., 2:])
    tail_resp = torch.cat([tail_resp[..., :1],
                           torch.maximum(tail_resp[..., 1:64], neigh),
                           tail_resp[..., 64:]], dim=-1)
    new = ReverbFrequencyResponseState(average_decay=new_avg,
                                       tail_response=tail_resp)
    return tree_where(quality_valid, new, st)


# ------------------------------------------------------------------ AecState


@dataclass
class AecStateState:
    """Top-level AecState carry; per-stream scalars are (B,)."""

    initial_state: torch.Tensor  # bool
    transition_triggered: torch.Tensor  # bool
    initial_strong_blocks: torch.Tensor  # int32
    capture_signal_saturation: torch.Tensor  # bool
    blocks_with_active_render: torch.Tensor  # int32
    strong_not_saturated_render_blocks: torch.Tensor  # int32
    filter_delays_blocks: torch.Tensor  # (B, C) int32
    min_filter_delay: torch.Tensor  # int32
    external_delay: torch.Tensor  # int32
    external_delay_valid: torch.Tensor  # bool
    usable_linear_estimate: torch.Tensor  # bool
    filter_update_blocks_since_reset: torch.Tensor  # int32
    filter_update_blocks_since_start: torch.Tensor  # int32
    convergence_seen: torch.Tensor  # bool
    saturated_echo: torch.Tensor  # bool
    # 1-second average of the all-filters-diverged indicator (a stat).
    divergent_fraction: torch.Tensor  # float32
    subtractor_analyzer: SubtractorOutputAnalyzerState
    filter_analyzer: FilterAnalyzerState
    transparent: TransparentModeState
    erle: ErleState
    erl: ErlState
    avg_render_reverb: ReverbModelState
    reverb_freq_response: ReverbFrequencyResponseState
    echo_audibility: ea.EchoAudibilityState
    # The adaptive ReverbDecayEstimator, only when default_len < 0.
    reverb_decay_est: rde.ReverbDecayState | None = None

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def init_state(config: EchoCanceller3Config, num_capture: int, p_max: int,
               batch: int, device) -> AecStateState:
    hb = config.delay.delay_headroom_samples // BLOCK_SIZE
    B = batch

    def i(v, shape=(B,)):
        return _full(shape, v, _I32, device)

    def b(v, shape=(B,)):
        return _full(shape, v, torch.bool, device)

    return AecStateState(
        initial_state=b(True), transition_triggered=b(False),
        initial_strong_blocks=i(0), capture_signal_saturation=b(False),
        blocks_with_active_render=i(0),
        strong_not_saturated_render_blocks=i(0),
        filter_delays_blocks=i(hb, (B, num_capture)),
        min_filter_delay=i(hb), external_delay=i(0),
        external_delay_valid=b(False), usable_linear_estimate=b(False),
        filter_update_blocks_since_reset=i(0),
        filter_update_blocks_since_start=i(0), convergence_seen=b(False),
        saturated_echo=b(False),
        divergent_fraction=_full((B,), 0.0, torch.float32, device),
        subtractor_analyzer=SubtractorOutputAnalyzerState(
            filters_converged=b(False, (B, num_capture))),
        filter_analyzer=init_filter_analyzer(config, num_capture, p_max, B,
                                             device),
        transparent=init_transparent_mode(B, device),
        erle=init_erle(config, num_capture, B, device),
        erl=init_erl(B, device),
        avg_render_reverb=ReverbModelState(
            reverb=_full((B, NUM_BINS), 0.0, torch.float32, device)),
        reverb_freq_response=ReverbFrequencyResponseState(
            average_decay=_full((B, num_capture), 0.0, torch.float32,
                                device),
            tail_response=_full((B, num_capture, NUM_BINS), 0.0,
                                torch.float32, device)),
        echo_audibility=ea.init_state(B, device),
        reverb_decay_est=(rde.init_state(config, num_capture, B, device)
                          if config.ep_strength.default_len < 0 else None),
    )


def handle_echo_path_change(config, state: AecStateState, delay_change,
                            gain_change):
    """AecState::HandleEchoPathChange (aec_state.cc:146-176); delay_change
    and gain_change (B,) bool."""
    B = delay_change.shape[0]
    dev = delay_change.device
    f = torch.zeros_like(delay_change)
    z = torch.zeros((B,), dtype=_I32, device=dev)
    converged0 = torch.zeros_like(state.subtractor_analyzer.filters_converged)
    full = state.replace(
        filter_analyzer=reset_filter_analyzer(config, state.filter_analyzer),
        capture_signal_saturation=f,
        strong_not_saturated_render_blocks=z,
        blocks_with_active_render=z,
        initial_state=~f,
        initial_strong_blocks=z,
        transparent=init_transparent_mode(B, dev),
        erle=reset_erle(config, state.erle, True),
        erl=state.erl.replace(blocks_since_reset=z),
        usable_linear_estimate=f,
        filter_update_blocks_since_reset=z,
        convergence_seen=f,
        subtractor_analyzer=SubtractorOutputAnalyzerState(
            filters_converged=converged0),
    )
    state = tree_where(delay_change, full, state)
    # A gain change alone resets the ERLE without its block counter.
    erle = tree_where(gain_change & ~delay_change,
                      reset_erle(config, state.erle, False), state.erle)
    conv = state.subtractor_analyzer.filters_converged & ~(
        delay_change | gain_change)[:, None]
    return state.replace(erle=erle, subtractor_analyzer=(
        SubtractorOutputAnalyzerState(filters_converged=conv)))


def update(config: EchoCanceller3Config, state: AecStateState,
           geo: rb.BufferGeometry, view: rb.RenderView, external_delay,
           external_delay_valid, frequency_responses, impulse_responses,
           filter_size_partitions, E2_refined, Y2, sub_out, spec_win,
           blocks_win):
    """AecState::Update (aec_state.cc:179-299), with every render read
    taken from the windows at the read position: spec_win (B, W, C_ren,
    65) and blocks_win (B, W, bands, 64, C_ren)."""
    dev = Y2.device
    B = Y2.shape[0]
    sa, any_conv, _any_coarse, all_div = analyze_subtractor_output(
        sub_out["y2"], sub_out["e2_refined"], sub_out["e2_coarse"])
    fa, any_consistent, max_echo_path_gain = filter_analyzer_update(
        config, state.filter_analyzer, impulse_responses,
        filter_size_partitions * BLOCK_SIZE, blocks_win)

    # FilterDelay update (aec_state.cc:373-398).
    ext_delay = torch.where(external_delay_valid, external_delay,
                            state.external_delay)
    ext_valid = state.external_delay_valid | external_delay_valid
    hb = config.delay.delay_headroom_samples // BLOCK_SIZE
    not_converged = (state.strong_not_saturated_render_blocks
                     < 2 * BLOCKS_PER_SECOND)
    use_guess = (not_converged & ext_valid)[:, None]
    filter_delays = torch.where(use_guess, hb,
                                fa.filter_delays_blocks).to(_I32)
    min_delay = torch.min(filter_delays, dim=1)[0]

    # Active render counters (aec_state.cc:210-228).
    aligned = take(blocks_win, min_delay)  # (B, bands, 64, C_ren)
    x_energy = torch.sum(aligned[:, 0] ** 2, dim=1)
    active_render = torch.any(
        x_energy > config.render_levels.active_render_limit ** 2 * BLOCK_SIZE,
        dim=1)
    saturated = state.capture_signal_saturation
    blocks_active = state.blocks_with_active_render + active_render.to(_I32)
    strong_blocks = state.strong_not_saturated_render_blocks + (
        active_render & ~saturated).to(_I32)

    # ComputeAvgRenderReverb (aec_state.cc:46-97).
    decay = rde.decay_value(config, state.reverb_decay_est,
                            torch.zeros((B,), dtype=torch.bool, device=dev))
    X2_rows = take(spec_win, torch.stack([min_delay, min_delay + 1], dim=1))
    X2_at_ch = X2_rows[:, 0]  # (B, C_ren, 65)
    X2_at = torch.mean(X2_rows[:, 0], dim=1)
    X2_past = torch.mean(X2_rows[:, 1], dim=1)
    reverb = reverb_update(state.avg_render_reverb, X2_past, 1.0, decay)
    X2_reverb = X2_at + reverb.reverb

    audibility = state.echo_audibility
    if config.echo_audibility.use_stationarity_properties:
        newest = rb.blocks_span(
            geo, view,
            torch.zeros_like(min_delay) + rb.b_write_index(geo, view.n), 1)
        newest_band0 = rb.blocks_rows(geo, newest)[:, 0, 0]  # (B, 64, C)
        audibility = ea.update(
            audibility, geo, view, rb.s_read_index(geo, view.state, view.n),
            rb.s_write_index(geo, view.n), newest_band0, reverb.reverb,
            min_delay, rb.headroom(geo, view.state), external_delay_valid,
            config.echo_audibility.use_stationarity_properties_at_init)

    # ERLE and ERL; the previous update's transition resets the ERLE first.
    erle = tree_where(state.transition_triggered,
                      reset_erle(config, state.erle, False), state.erle)
    X2_by_delay = None
    if config.erle.num_sections > 1:
        P_ref = config.filter.refined.length_blocks
        X2_by_delay = torch.mean(spec_win[:, :P_ref], dim=2)
    erle = erle_update(config, erle, X2_reverb, Y2, E2_refined,
                       sa.filters_converged, X2_by_delay, frequency_responses)
    erl = erl_update(state.erl, sa.filters_converged, X2_at_ch, Y2)

    # Saturation detection (aec_state.cc:439-470).
    usable_prev = state.usable_linear_estimate
    sat_lin = torch.any((sub_out["s_refined_max_abs"] > 20000.0)
                        | (sub_out["s_coarse_max_abs"] > 20000.0), dim=1)
    max_sample = torch.amax(torch.abs(aligned[:, 0]), dim=(1, 2))
    sat_nonlin = max_sample * max_echo_path_gain * 10.0 > 32000.0
    saturated_echo = saturated & torch.where(usable_prev, sat_lin, sat_nonlin)
    if not config.ep_strength.echo_can_saturate:
        saturated_echo = torch.zeros_like(saturated_echo)

    # InitialState::Update.
    init_strong = state.initial_strong_blocks + (
        active_render & ~saturated).to(_I32)
    if config.filter.conservative_initial_phase:
        still_initial = init_strong < 5 * BLOCKS_PER_SECOND
    else:
        still_initial = init_strong < (config.filter.initial_state_seconds
                                       * BLOCKS_PER_SECOND)
    transition = ~still_initial & state.initial_state

    transparent = state.transparent
    if not config.ep_strength.bounded_erl:
        transparent = transparent_mode_update(
            transparent, min_delay, any_consistent, any_conv, all_div,
            active_render, saturated)

    # FilteringQualityAnalyzer::Update (aec_state.cc:400-437).
    filter_update = (active_render & ~saturated).to(_I32)
    upd_reset = state.filter_update_blocks_since_reset + filter_update
    upd_start = state.filter_update_blocks_since_start + filter_update
    conv_seen = state.convergence_seen | any_conv
    suff_start = upd_start > BLOCKS_PER_SECOND * 0.4
    suff_reset = suff_start & (upd_reset > BLOCKS_PER_SECOND * 0.2)
    usable = suff_start & suff_reset & (ext_valid | conv_seen)
    if not config.ep_strength.bounded_erl:
        usable = usable & ~transparent.active
    if not config.filter.use_linear_filter:
        usable = torch.zeros_like(usable)

    # Reverb model estimation (aec_state.cc:298-308).
    quality = erle.fullband.inst_quality
    quality_valid = erle.fullband.erle_log2_valid
    stationary_block = torch.zeros_like(usable)
    if config.echo_audibility.use_stationarity_properties:
        stationary_block = ea.is_block_stationary(audibility)
        quality_valid = quality_valid & ~stationary_block[:, None]
    rfr = reverb_frequency_response_update(
        config, state.reverb_freq_response, frequency_responses,
        filter_delays, quality, quality_valid, filter_size_partitions - 1)
    rde_state = state.reverb_decay_est
    if config.ep_strength.default_len < 0:
        rde_state = rde.update(
            config, rde_state, fa.h_highpass, erle.fullband.inst_quality,
            erle.fullband.erle_log2_valid, filter_delays, usable,
            stationary_block, filter_size_partitions)

    div_frac = state.divergent_fraction + (
        all_div.to(torch.float32) - state.divergent_fraction) * (
        1.0 / BLOCKS_PER_SECOND)

    return state.replace(
        divergent_fraction=div_frac,
        reverb_decay_est=rde_state,
        initial_state=still_initial,
        transition_triggered=transition,
        initial_strong_blocks=init_strong.to(_I32),
        blocks_with_active_render=blocks_active.to(_I32),
        strong_not_saturated_render_blocks=strong_blocks.to(_I32),
        filter_delays_blocks=filter_delays,
        min_filter_delay=min_delay.to(_I32),
        external_delay=ext_delay.to(_I32),
        external_delay_valid=ext_valid,
        usable_linear_estimate=usable,
        filter_update_blocks_since_reset=upd_reset.to(_I32),
        filter_update_blocks_since_start=upd_start.to(_I32),
        convergence_seen=conv_seen,
        saturated_echo=saturated_echo,
        subtractor_analyzer=sa,
        filter_analyzer=fa,
        transparent=transparent,
        erle=erle,
        erl=erl,
        avg_render_reverb=reverb,
        reverb_freq_response=rfr,
        echo_audibility=audibility,
    )


def residual_echo_scaling(config, state: AecStateState):
    """AecState::GetResidualEchoScaling (aec_state.cc:115-126): (B, 65)."""
    limit = (1.5 if config.filter.conservative_initial_phase else 0.8) * 250
    converged = state.strong_not_saturated_render_blocks >= limit
    return ea.residual_echo_scaling(
        state.echo_audibility, converged,
        config.echo_audibility.use_stationarity_properties_at_init)


def transparent_mode_active(config, state: AecStateState):
    if config.ep_strength.bounded_erl:
        return torch.zeros_like(state.transparent.active)
    return state.transparent.active
