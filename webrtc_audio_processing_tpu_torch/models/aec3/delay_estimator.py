"""AEC3 delay estimation: matched-filter bank, lag aggregation, controller.

Port of ``webrtc_audio_processing_tpu/models/aec3/delay_estimator.py``
(reference: aec3/matched_filter.cc, aec3/matched_filter_lag_aggregator.cc,
aec3/clockdrift_detector.cc, aec3/echo_path_delay_estimator.cc,
aec3/render_delay_controller.cc).

The NLMS bank is K3 (``ops/cuda_matched_filter.py``) and the winner's
pre-echo errors K4 (``ops/cuda_pre_echo.py``); the capture decimator rides
K1. The JAX twin's one-hot selects over the five filters become gathers.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from webrtc_audio_processing_tpu_torch.models.aec3 import render_buffer as rb
from webrtc_audio_processing_tpu_torch.models.aec3.config import (
    EchoCanceller3Config,
)
from webrtc_audio_processing_tpu_torch.ops import (
    biquad,
    cuda_matched_filter,
    cuda_pre_echo,
)
from webrtc_audio_processing_tpu_torch.ops.batch import take, tree_where

BLOCK_SIZE = 64
BLOCK_SIZE_LOG2 = 6
NUM_BLOCKS_PER_SECOND = 250
WINDOW_SUB_BLOCKS = 32  # kMatchedFilterWindowSizeSubBlocks
SHIFT_SUB_BLOCKS = 24  # kMatchedFilterAlignmentShiftSizeSubBlocks
ACC_ERR_RATE = 4  # kAccumulatedErrorSubSampleRate
HISTOGRAM_DATA_SIZE = 250

_I32 = torch.int32


@dataclass(frozen=True)
class DelayGeometry:
    """Static sizes for the delay estimation path."""

    down_sampling_factor: int
    sub_block_size: int
    num_filters: int
    filter_length: int  # taps per matched filter
    shift_samples: int  # filter_intra_lag_shift_
    ds_size: int
    max_filter_lag: int
    peak_histogram_size: int
    pre_echo_histogram_size: int
    ds_block_size_log2: int

    @staticmethod
    def create(config: EchoCanceller3Config) -> "DelayGeometry":
        ds = config.delay.down_sampling_factor
        sub = BLOCK_SIZE // ds
        filter_length = WINDOW_SUB_BLOCKS * sub
        shift = SHIFT_SUB_BLOCKS * sub
        nf = config.delay.num_filters
        max_lag = nf * shift + filter_length
        return DelayGeometry(
            down_sampling_factor=ds,
            sub_block_size=sub,
            num_filters=nf,
            filter_length=filter_length,
            shift_samples=shift,
            ds_size=rb.get_down_sampled_buffer_size(ds, nf),
            max_filter_lag=max_lag,
            peak_histogram_size=max_lag + 1,
            pre_echo_histogram_size=((max_lag + 1) * ds) >> BLOCK_SIZE_LOG2,
            ds_block_size_log2=max(BLOCK_SIZE_LOG2 - (ds.bit_length() - 1),
                                   0),
        )


@dataclass
class MatchedFilterState:
    filters: torch.Tensor  # (B, N, L)
    accumulated_error: torch.Tensor  # (B, N, L/4), init 1
    number_pre_echo_updates: torch.Tensor  # (B,) int32
    last_detected_best_lag_filter: torch.Tensor  # (B,) int32, -1 = none
    reported_lag: torch.Tensor  # (B,) int32
    reported_pre_echo_lag: torch.Tensor  # (B,) int32
    reported_valid: torch.Tensor  # (B,) bool

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass
class PeakAggregatorState:
    histogram: torch.Tensor  # (B, peak_histogram_size) int32
    histogram_data: torch.Tensor  # (B, 250) int32
    histogram_data_index: torch.Tensor  # (B,) int32
    candidate: torch.Tensor  # (B,) int32


@dataclass
class PreEchoAggregatorState:
    histogram: torch.Tensor  # (B, pre_echo_histogram_size) int32
    histogram_data: torch.Tensor  # (B, 250) int32, -1 = not updated
    histogram_data_index: torch.Tensor  # (B,) int32
    pre_echo_candidate: torch.Tensor  # (B,) int32
    number_updates: torch.Tensor  # (B,) int32


@dataclass
class LagAggregatorState:
    peak: PeakAggregatorState
    pre_echo: PreEchoAggregatorState
    significant_candidate_found: torch.Tensor  # (B,) bool


@dataclass
class ClockdriftState:
    delay_history: torch.Tensor  # (B, 3) int32
    stability_counter: torch.Tensor  # (B,) int32
    level: torch.Tensor  # (B,) int32: 0 none, 1 probable, 2 verified


@dataclass
class DelayEstimatorState:
    matched_filter: MatchedFilterState
    aggregator: LagAggregatorState
    clockdrift: ClockdriftState
    capture_mixer: rb.AlignmentMixerState
    capture_decimator_aa: biquad.BiquadCascadeState
    capture_decimator_nr: biquad.BiquadCascadeState
    # EchoPathDelayEstimator (echo_path_delay_estimator.h).
    old_lag: torch.Tensor  # (B,) int32
    old_lag_valid: torch.Tensor  # (B,) bool
    consistent_estimate_counter: torch.Tensor  # (B,) int32
    # RenderDelayController (render_delay_controller.cc).
    delay_blocks: torch.Tensor  # (B,) int32
    delay_valid: torch.Tensor  # (B,) bool
    delay_samples: torch.Tensor  # (B,) int32
    delay_samples_valid: torch.Tensor  # (B,) bool
    delay_samples_refined: torch.Tensor  # (B,) bool
    delay_change_counter: torch.Tensor  # (B,) int32
    last_delay_estimate_refined: torch.Tensor  # (B,) bool

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def _zeros(batch, dtype, device, shape=()):
    return torch.zeros((batch,) + tuple(shape), dtype=dtype, device=device)


def _init_matched_filter(geo: DelayGeometry, batch: int, device):
    nf, L = geo.num_filters, geo.filter_length
    return MatchedFilterState(
        filters=_zeros(batch, torch.float32, device, (nf, L)),
        accumulated_error=torch.ones((batch, nf, L // ACC_ERR_RATE),
                                     dtype=torch.float32, device=device),
        number_pre_echo_updates=_zeros(batch, _I32, device),
        last_detected_best_lag_filter=torch.full((batch,), -1, dtype=_I32,
                                                 device=device),
        reported_lag=_zeros(batch, _I32, device),
        reported_pre_echo_lag=_zeros(batch, _I32, device),
        reported_valid=_zeros(batch, torch.bool, device),
    )


def _init_aggregator(geo: DelayGeometry, batch: int, device):
    return LagAggregatorState(
        peak=PeakAggregatorState(
            histogram=_zeros(batch, _I32, device, (geo.peak_histogram_size,)),
            histogram_data=_zeros(batch, _I32, device, (HISTOGRAM_DATA_SIZE,)),
            histogram_data_index=_zeros(batch, _I32, device),
            candidate=_zeros(batch, _I32, device),
        ),
        pre_echo=PreEchoAggregatorState(
            histogram=_zeros(batch, _I32, device,
                             (geo.pre_echo_histogram_size,)),
            histogram_data=torch.full((batch, HISTOGRAM_DATA_SIZE), -1,
                                      dtype=_I32, device=device),
            histogram_data_index=_zeros(batch, _I32, device),
            pre_echo_candidate=_zeros(batch, _I32, device),
            number_updates=_zeros(batch, _I32, device),
        ),
        significant_candidate_found=_zeros(batch, torch.bool, device),
    )


def init_state(geo: DelayGeometry, config: EchoCanceller3Config,
               num_channels: int, batch: int, device) -> DelayEstimatorState:
    return DelayEstimatorState(
        matched_filter=_init_matched_filter(geo, batch, device),
        aggregator=_init_aggregator(geo, batch, device),
        clockdrift=ClockdriftState(
            delay_history=_zeros(batch, _I32, device, (3,)),
            stability_counter=_zeros(batch, _I32, device),
            level=_zeros(batch, _I32, device),
        ),
        capture_mixer=rb.init_mixer(batch, num_channels, device),
        capture_decimator_aa=biquad.init_state(3, batch, None, device),
        capture_decimator_nr=biquad.init_state(1, batch, None, device),
        old_lag=_zeros(batch, _I32, device),
        old_lag_valid=_zeros(batch, torch.bool, device),
        consistent_estimate_counter=_zeros(batch, _I32, device),
        delay_blocks=_zeros(batch, _I32, device),
        delay_valid=_zeros(batch, torch.bool, device),
        delay_samples=_zeros(batch, _I32, device),
        delay_samples_valid=_zeros(batch, torch.bool, device),
        delay_samples_refined=_zeros(batch, torch.bool, device),
        delay_change_counter=_zeros(batch, _I32, device),
        last_delay_estimate_refined=_zeros(batch, torch.bool, device),
    )


def _reset_matched_filter(state: MatchedFilterState, full_reset: bool):
    """MatchedFilter::Reset (matched_filter.cc)."""
    new = state.replace(filters=torch.zeros_like(state.filters),
                        reported_valid=torch.zeros_like(state.reported_valid))
    if full_reset:
        new = new.replace(
            accumulated_error=torch.ones_like(state.accumulated_error),
            number_pre_echo_updates=torch.zeros_like(
                state.number_pre_echo_updates))
    return new


def matched_filter_update(
    geo: DelayGeometry,
    config: EchoCanceller3Config,
    state: MatchedFilterState,
    lowrate: torch.Tensor,  # (B, DS) low-rate render ring
    lr_read: torch.Tensor,  # (B,) read index
    capture_ds: torch.Tensor,  # (B, sub) decimated capture
    use_slow_smoothing: torch.Tensor,  # (B,) bool
) -> MatchedFilterState:
    """MatchedFilter::Update (matched_filter.cc:693-812) for all N filters."""
    n_filters, length = state.filters.shape[1:]
    sub = geo.sub_block_size
    y = capture_ds
    dev = y.device
    excitation_limit = (
        config.render_levels.poor_excitation_render_limit_ds8
        if geo.down_sampling_factor == 8
        else config.render_levels.poor_excitation_render_limit)
    smoothing = torch.where(
        use_slow_smoothing,
        config.delay.delay_estimate_smoothing_delay_found,
        config.delay.delay_estimate_smoothing).to(torch.float32)
    x2_sum_threshold = length * excitation_limit ** 2

    error_sum_anchor = torch.sum(y * y, dim=1)  # (B,)
    acc_chunks = length // ACC_ERR_RATE

    # K3: the NLMS bank, with the per-sample steps and the segments.
    h, alphas, error_sums, filters_updated, segs = cuda_matched_filter.nlms(
        lowrate, lr_read, state.filters, y, smoothing,
        shift=geo.shift_samples, ds_size=geo.ds_size,
        threshold=float(x2_sum_threshold))

    # Lag estimates: peak of h^2 per filter (aec3::MaxSquarePeakIndex).
    lag_estimates = torch.argmax(h * h, dim=-1).to(_I32)  # (B, N)
    reliable = (
        (lag_estimates > 2) & (lag_estimates < length - 10)
        & (error_sums < config.delay.delay_candidate_detection_threshold
           * error_sum_anchor[:, None]))

    # Winner search (matched_filter.cc:764-790): ascending n, strict <.
    lags = lag_estimates + torch.arange(n_filters, device=dev,
                                        dtype=_I32) * geo.shift_samples
    winner_error = error_sum_anchor
    winner_index = torch.full_like(state.reported_lag, -1)
    winner_lag = torch.zeros_like(state.reported_lag)
    for n in range(n_filters):
        take_n = (filters_updated[:, n] & reliable[:, n]
                  & (error_sums[:, n] < winner_error))
        same_as_prev = (lags[:, n - 1] == lags[:, n]) if n > 0 else \
            torch.zeros_like(take_n)
        winner_lag = torch.where(
            take_n, torch.where(same_as_prev, lags[:, n - 1] if n else 0,
                                lags[:, n]), winner_lag)
        winner_index = torch.where(
            take_n, torch.where(same_as_prev, n - 1, n), winner_index)
        winner_error = torch.where(take_n, error_sums[:, n], winner_error)
    winner_lag = winner_lag.to(_I32)
    winner_index = winner_index.to(_I32)
    found = winner_index != -1

    # Pre-echo accumulated-error update (matched_filter.cc:792-812); the
    # instantaneous error belongs to filter last_detected_best_lag_filter.
    acc_err = state.accumulated_error
    num_updates = state.number_pre_echo_updates
    pre_echo_lag = winner_lag
    if config.delay.detect_pre_echo:
        matches_last = found & (
            state.last_detected_best_lag_filter == winner_index)
        do_acc = matches_last & (error_sum_anchor > 1.0)
        winner_row = torch.clamp(winner_index, min=0)
        # K4 on the winner's segment, starting filter and steps.
        inst = cuda_pre_echo.pre_echo_inst(
            take(segs, winner_row), take(state.filters, winner_row),
            take(alphas, winner_row), y, ACC_ERR_RATE)
        err_norm = inst / torch.clamp(error_sum_anchor, min=1e-30)[:, None]
        cur = take(acc_err, winner_row)  # (B, chunks)
        new_row = torch.where(err_norm < cur, err_norm,
                              cur + 0.015 * (err_norm - cur))
        row_oh = (torch.arange(n_filters, device=dev)[None, :]
                  == winner_row[:, None])  # (B, N)
        acc_err = torch.where((do_acc[:, None] & row_oh)[:, :, None],
                              new_row[:, None, :], acc_err)
        num_updates = (num_updates + do_acc.to(_I32)).to(_I32)

        # ComputePreEchoLag (matched_filter.cc:60-78).
        shift_winner = winner_row * geo.shift_samples
        base_estimate = winner_lag - shift_winner
        max_pre_lag = torch.clamp(
            torch.div(base_estimate, ACC_ERR_RATE, rounding_mode="floor"),
            max=acc_chunks)
        row = take(acc_err, winner_row)
        ks = torch.arange(acc_chunks, device=dev)
        in_range = ks[None, :] < max_pre_lag[:, None]
        # blocked[k] = any(row[j] > 0.5 for j in [k, max_pre_lag)).
        over = ((row > 0.5) & in_range).to(_I32)
        blocked = torch.flip(torch.cumsum(torch.flip(over, [1]), 1), [1]) > 0
        ok = in_range & ~blocked
        k_min = torch.min(torch.where(ok, ks[None, :], acc_chunks), dim=1)[0]
        computed = torch.where(k_min < acc_chunks,
                               (k_min + 1) * ACC_ERR_RATE - 1, base_estimate)
        pre_echo_estimate = computed + shift_winner
        pre_echo_lag = torch.where(matches_last & (num_updates >= 50),
                                   pre_echo_estimate, winner_lag).to(_I32)

    return state.replace(
        filters=h,
        accumulated_error=acc_err,
        number_pre_echo_updates=num_updates,
        last_detected_best_lag_filter=torch.where(
            found, winner_index, state.last_detected_best_lag_filter),
        reported_lag=torch.where(found, winner_lag, state.reported_lag),
        reported_pre_echo_lag=torch.where(found, pre_echo_lag,
                                          state.reported_pre_echo_lag),
        reported_valid=found,
    )


def _one_hot(idx: torch.Tensor, size: int) -> torch.Tensor:
    return (torch.arange(size, device=idx.device)[None, :]
            == idx[:, None]).to(_I32)


def _peak_aggregate(state: PeakAggregatorState, lag):
    """HighestPeakAggregator::Aggregate (matched_filter_lag_aggregator.cc)."""
    size = state.histogram.shape[1]
    old = take(state.histogram_data, state.histogram_data_index)
    hist = state.histogram - _one_hot(old, size) + _one_hot(lag, size)
    slot = _one_hot(state.histogram_data_index, HISTOGRAM_DATA_SIZE)
    return PeakAggregatorState(
        histogram=hist,
        histogram_data=state.histogram_data * (1 - slot) + lag[:, None] * slot,
        histogram_data_index=torch.remainder(
            state.histogram_data_index + 1, HISTOGRAM_DATA_SIZE).to(_I32),
        candidate=torch.argmax(hist, dim=1).to(_I32),
    )


def _pre_echo_aggregate(geo: DelayGeometry, state: PreEchoAggregatorState,
                        pre_echo_lag):
    """PreEchoLagAggregator::Aggregate (matched_filter_lag_aggregator.cc)."""
    size = state.histogram.shape[1]
    block = torch.clamp(pre_echo_lag >> geo.ds_block_size_log2, 0, size - 1)
    old = take(state.histogram_data, state.histogram_data_index)
    hist = (state.histogram
            - torch.where((old != -1)[:, None],
                          _one_hot(torch.clamp(old, min=0), size), 0)
            + _one_hot(block, size))

    number_updates = state.number_updates
    in_startup = number_updates < NUM_BLOCKS_PER_SECOND * 2
    number_updates = torch.where(in_startup, number_updates + 1,
                                 number_updates)

    # Penalized stride-window search during startup.
    n_windows = (size - WINDOW_SUB_BLOCKS) // WINDOW_SUB_BLOCKS + 1
    w = hist[:, : n_windows * WINDOW_SUB_BLOCKS].reshape(
        -1, n_windows, WINDOW_SUB_BLOCKS)
    w_max = torch.max(w, dim=-1)[0].to(torch.float32)
    w_arg = torch.argmax(w, dim=-1)
    penal = torch.pow(0.7, torch.arange(n_windows, device=hist.device,
                                        dtype=torch.float32))
    best_w = torch.argmax(w_max * penal, dim=1)
    startup_candidate = best_w * WINDOW_SUB_BLOCKS + take(w_arg, best_w)
    plain_candidate = torch.argmax(hist, dim=1)
    cand_block = torch.where(in_startup, startup_candidate, plain_candidate)

    slot = _one_hot(state.histogram_data_index, HISTOGRAM_DATA_SIZE)
    return PreEchoAggregatorState(
        histogram=hist,
        histogram_data=(state.histogram_data * (1 - slot)
                        + block[:, None] * slot).to(_I32),
        histogram_data_index=torch.remainder(
            state.histogram_data_index + 1, HISTOGRAM_DATA_SIZE).to(_I32),
        pre_echo_candidate=(cand_block << geo.ds_block_size_log2).to(_I32),
        number_updates=number_updates.to(_I32),
    )


def aggregate(geo: DelayGeometry, config: EchoCanceller3Config,
              state: LagAggregatorState, lag, pre_echo_lag, lag_valid):
    """MatchedFilterLagAggregator::Aggregate
    (matched_filter_lag_aggregator.cc:81-110).

    Returns (state, delay, delay_valid, refined_quality)."""
    headroom = int(config.delay.delay_headroom_samples
                   // config.delay.down_sampling_factor)
    pre_echo = tree_where(
        lag_valid,
        _pre_echo_aggregate(geo, state.pre_echo,
                            torch.clamp(pre_echo_lag - headroom, min=0)),
        state.pre_echo)
    peak = tree_where(
        lag_valid,
        _peak_aggregate(state.peak, torch.clamp(lag - headroom, min=0)),
        state.peak)

    count = take(peak.histogram, peak.candidate)
    thr = config.delay.delay_selection_thresholds
    significant = state.significant_candidate_found | (
        lag_valid & (count > thr.converged))
    emit = lag_valid & (
        (count > thr.converged)
        | ((count > thr.initial) & ~state.significant_candidate_found))
    delay = (pre_echo.pre_echo_candidate if config.delay.detect_pre_echo
             else peak.candidate)
    return (
        LagAggregatorState(peak=peak, pre_echo=pre_echo,
                           significant_candidate_found=significant),
        delay,
        emit,
        significant,
    )


def _reset_aggregator(state: LagAggregatorState, hard_reset: bool):
    B = state.significant_candidate_found.shape[0]
    dev = state.significant_candidate_found.device
    sizes = (state.peak.histogram.shape[1], state.pre_echo.histogram.shape[1])
    new = LagAggregatorState(
        peak=PeakAggregatorState(
            histogram=_zeros(B, _I32, dev, (sizes[0],)),
            histogram_data=_zeros(B, _I32, dev, (HISTOGRAM_DATA_SIZE,)),
            histogram_data_index=_zeros(B, _I32, dev),
            candidate=_zeros(B, _I32, dev),
        ),
        pre_echo=PreEchoAggregatorState(
            histogram=_zeros(B, _I32, dev, (sizes[1],)),
            histogram_data=torch.full((B, HISTOGRAM_DATA_SIZE), -1,
                                      dtype=_I32, device=dev),
            histogram_data_index=_zeros(B, _I32, dev),
            pre_echo_candidate=_zeros(B, _I32, dev),
            number_updates=_zeros(B, _I32, dev),
        ),
        significant_candidate_found=(
            _zeros(B, torch.bool, dev) if hard_reset
            else state.significant_candidate_found),
    )
    return new


def _clockdrift_update(state: ClockdriftState, delay_estimate, enabled):
    """ClockdriftDetector::Update (clockdrift_detector.cc:19-58)."""
    hist = state.delay_history
    same = delay_estimate == hist[:, 0]
    stab = torch.where(same, state.stability_counter + 1, 0)
    level = torch.where(same & (stab > 7500), 0, state.level)
    d1 = hist[:, 0] - delay_estimate
    d2 = hist[:, 1] - delay_estimate
    d3 = hist[:, 2] - delay_estimate
    prob_up = ((d1 == -1) & (d2 == -2)) | ((d1 == -2) & (d2 == -1))
    drift_up = prob_up & (d3 == -3)
    prob_down = ((d1 == 1) & (d2 == 2)) | ((d1 == 2) & (d2 == 1))
    drift_down = prob_down & (d3 == 3)
    new_level = torch.where(
        drift_up | drift_down, 2,
        torch.where((prob_up | prob_down) & (state.level == 0), 1,
                    state.level))
    level = torch.where(same, level, new_level)
    history = torch.where(
        same[:, None], hist,
        torch.stack([delay_estimate, hist[:, 0], hist[:, 1]], dim=1))
    out = ClockdriftState(delay_history=history.to(_I32),
                          stability_counter=stab.to(_I32),
                          level=level.to(_I32))
    return tree_where(enabled, out, state)


def get_delay(geo: DelayGeometry, config: EchoCanceller3Config,
              state: DelayEstimatorState, lowrate, lr_read, capture_block):
    """RenderDelayControllerImpl::GetDelay (render_delay_controller.cc:99-166)
    with EchoPathDelayEstimator::EstimateDelay
    (echo_path_delay_estimator.cc:66-124). capture_block (B, bands, 64, C).

    Returns (state, delay_blocks, delay_valid), each (B,)."""
    band0 = capture_block[:, 0].transpose(1, 2)  # (B, C, 64)
    mixer, mono = rb.alignment_mix(config.delay.capture_alignment_mixing,
                                   state.capture_mixer, band0)
    aa, nr, capture_ds = rb.decimate(
        geo.down_sampling_factor, state.capture_decimator_aa,
        state.capture_decimator_nr, mono)
    state = state.replace(capture_mixer=mixer, capture_decimator_aa=aa,
                          capture_decimator_nr=nr)

    mf = matched_filter_update(
        geo, config, state.matched_filter, lowrate, lr_read, capture_ds,
        state.aggregator.significant_candidate_found)
    agg, lag_samples_ds, lag_valid, refined = aggregate(
        geo, config, state.aggregator, mf.reported_lag,
        mf.reported_pre_echo_lag, mf.reported_valid)

    # Clockdrift detection on the highest-peak candidate
    # (echo_path_delay_estimator.cc:96-101).
    clock = _clockdrift_update(state.clockdrift, agg.peak.candidate,
                               lag_valid & refined)
    delay_samples = lag_samples_ds * geo.down_sampling_factor

    # Consistent-estimate soft reset (echo_path_delay_estimator.cc:113-121).
    consistent = (state.old_lag_valid & lag_valid
                  & (state.old_lag == delay_samples))
    counter = torch.where(consistent, state.consistent_estimate_counter + 1,
                          0)
    soft_reset = counter > NUM_BLOCKS_PER_SECOND // 2
    mf = tree_where(soft_reset, _reset_matched_filter(mf, False), mf)
    counter = torch.where(soft_reset, 0, counter)
    state = state.replace(
        matched_filter=mf, aggregator=agg, clockdrift=clock,
        old_lag=delay_samples.to(_I32),
        old_lag_valid=lag_valid & ~soft_reset,
        consistent_estimate_counter=counter.to(_I32),
    )

    # Render delay controller aggregation (render_delay_controller.cc:108-160).
    changed = lag_valid & (~state.delay_samples_valid
                           | (state.delay_samples != delay_samples))
    dcc = torch.where(changed, 0, state.delay_change_counter)
    dcc = torch.where(dcc < 2 * NUM_BLOCKS_PER_SECOND, dcc + 1, dcc)
    delay_samples_state = torch.where(lag_valid, delay_samples,
                                      state.delay_samples)
    delay_samples_valid = state.delay_samples_valid | lag_valid
    delay_samples_refined = torch.where(lag_valid, refined,
                                        state.delay_samples_refined)

    # ComputeBufferDelay with hysteresis (render_delay_controller.cc:54-71).
    new_delay_blocks = delay_samples_state >> BLOCK_SIZE_LOG2
    hyst = torch.where(
        state.last_delay_estimate_refined & delay_samples_refined,
        config.delay.hysteresis_limit_blocks, 0)
    keep = (state.delay_valid & (new_delay_blocks > state.delay_blocks)
            & (new_delay_blocks <= state.delay_blocks + hyst))
    new_delay_blocks = torch.where(keep, state.delay_blocks, new_delay_blocks)
    delay_blocks = torch.where(delay_samples_valid, new_delay_blocks,
                               state.delay_blocks).to(_I32)
    delay_valid = state.delay_valid | delay_samples_valid
    state = state.replace(
        delay_blocks=delay_blocks,
        delay_valid=delay_valid,
        delay_samples=delay_samples_state.to(_I32),
        delay_samples_valid=delay_samples_valid,
        delay_samples_refined=delay_samples_refined,
        delay_change_counter=dcc.to(_I32),
        last_delay_estimate_refined=torch.where(
            delay_samples_valid, delay_samples_refined,
            state.last_delay_estimate_refined),
    )
    return state, delay_blocks, delay_valid


def reset_delay_controller(state: DelayEstimatorState,
                           reset_delay_confidence: torch.Tensor):
    """RenderDelayControllerImpl::Reset + EchoPathDelayEstimator::Reset,
    with a per-stream ``reset_delay_confidence`` (B,) bool."""
    z = torch.zeros_like(state.old_lag)
    f = torch.zeros_like(state.old_lag_valid)
    agg = _reset_aggregator(state.aggregator, False)
    agg.significant_candidate_found = (
        state.aggregator.significant_candidate_found & ~reset_delay_confidence)
    return state.replace(
        matched_filter=_reset_matched_filter(state.matched_filter, True),
        aggregator=agg,
        old_lag_valid=f,
        consistent_estimate_counter=z,
        delay_valid=f,
        delay_samples_valid=f,
        delay_change_counter=z,
        last_delay_estimate_refined=(state.last_delay_estimate_refined
                                     & ~reset_delay_confidence),
    )
