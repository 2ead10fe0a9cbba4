"""Noise suppressor: spectral Wiener filtering with quantile noise estimation.

Port of ``webrtc_audio_processing_tpu/models/noise_suppressor.py``
(reference: modules/audio_processing/ns/). One ``analyze`` + ``process``
pair per 10 ms frame, vectorized over a (B, C, 129) spectrum layout. The
JAX version's ``lax.cond`` on an all-zero frame becomes a per-stream select
of every state leaf.

Geometry (ns/ns_common.h:18-24): 160-sample frames at the 16 kHz band-0
rate, 256-point FFT with 96 samples of history, hybrid Hann/flat window.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from webrtc_audio_processing_tpu_torch.config import NoiseSuppressionLevel
from webrtc_audio_processing_tpu_torch.ops import mxu_fft
from webrtc_audio_processing_tpu_torch.ops.batch import const
from webrtc_audio_processing_tpu_torch.ops.fast_math import (
    exp_approx,
    fast_log2,
    log_approx,
)

FFT_SIZE = 256
NUM_BINS = FFT_SIZE // 2 + 1  # 129
FRAME_SIZE = 160
OVERLAP = FFT_SIZE - FRAME_SIZE  # 96

SHORT_STARTUP_BLOCKS = 50
LONG_STARTUP_BLOCKS = 200
FEATURE_UPDATE_WINDOW = 500
HISTOGRAM_SIZE = 1000
BIN_SIZE_LRT = 0.1
BIN_SIZE_SPEC_FLAT = 0.05
BIN_SIZE_SPEC_DIFF = 0.1
NUM_SIMULT = 3  # quantile_noise_estimator.h:23


def _window() -> np.ndarray:
    """Hybrid Hanning/flat window (noise_suppressor.cc:60-96)."""
    half = np.sin(np.pi * np.arange(96) / 192.0).astype(np.float32)
    return np.concatenate([half, np.ones(65, np.float32), half[95:0:-1]])


def _log_table() -> np.ndarray:
    """ln(i), zero below i=5 (noise_estimator.cc:33-56)."""
    log_i = np.log(np.maximum(np.arange(NUM_BINS), 1)).astype(np.float32)
    log_i[:5] = 0.0
    return log_i


@dataclass(frozen=True)
class SuppressionParams:
    """suppression_params.cc:19-47."""

    over_subtraction_factor: float
    minimum_attenuating_gain: float
    use_attenuation_adjustment: bool


SUPPRESSION_PARAMS = {
    NoiseSuppressionLevel.LOW: SuppressionParams(1.0, 0.5, False),
    NoiseSuppressionLevel.MODERATE: SuppressionParams(1.0, 0.25, True),
    NoiseSuppressionLevel.HIGH: SuppressionParams(1.1, 0.125, True),
    NoiseSuppressionLevel.VERY_HIGH: SuppressionParams(1.25, 0.09, True),
}


@dataclass
class NsState:
    """Per-stream NS state: (B, ...) with channels after the batch axis."""

    num_analyzed_frames: torch.Tensor  # (B,) int32, starts at -1
    analyze_analysis_memory: torch.Tensor  # (B, C, 96)
    prev_analysis_signal_spectrum: torch.Tensor  # (B, C, 129), init 1
    process_analysis_memory: torch.Tensor  # (B, C, 96)
    process_synthesis_memory: torch.Tensor  # (B, C, 96)
    process_delay_memory: torch.Tensor  # (B, C, num_bands-1, 96)
    white_noise_level: torch.Tensor  # (B, C)
    pink_noise_numerator: torch.Tensor  # (B, C)
    pink_noise_exp: torch.Tensor  # (B, C)
    prev_noise_spectrum: torch.Tensor  # (B, C, 129)
    conservative_noise_spectrum: torch.Tensor  # (B, C, 129)
    parametric_noise_spectrum: torch.Tensor  # (B, C, 129)
    noise_spectrum: torch.Tensor  # (B, C, 129)
    density: torch.Tensor  # (B, C, 3, 129), init 0.3
    log_quantile: torch.Tensor  # (B, C, 3, 129), init 8
    quantile: torch.Tensor  # (B, C, 129)
    counter: torch.Tensor  # (B, C, 3) int32
    num_updates: torch.Tensor  # (B, C) int32, init 1
    wiener_filter: torch.Tensor  # (B, C, 129), init 1
    initial_spectral_estimate: torch.Tensor  # (B, C, 129)
    spectrum_prev_process: torch.Tensor  # (B, C, 129)
    prior_speech_prob: torch.Tensor  # (B, C), init 0.5
    speech_probability: torch.Tensor  # (B, C, 129)
    lrt: torch.Tensor  # (B, C), init 0.5
    spectral_flatness: torch.Tensor  # (B, C), init 0.5
    spectral_diff: torch.Tensor  # (B, C), init 0.5
    avg_log_lrt: torch.Tensor  # (B, C, 129), init 0.5
    diff_normalization: torch.Tensor  # (B, C)
    signal_energy_sum: torch.Tensor  # (B, C)
    histogram_analysis_counter: torch.Tensor  # (B, C) int32, init 500
    prior_lrt: torch.Tensor  # (B, C), init 0.5
    prior_flatness_threshold: torch.Tensor  # (B, C), init 0.5
    prior_template_diff_threshold: torch.Tensor  # (B, C), init 0.5
    prior_lrt_weighting: torch.Tensor  # (B, C), init 1
    prior_flatness_weighting: torch.Tensor  # (B, C)
    prior_difference_weighting: torch.Tensor  # (B, C)
    histograms: torch.Tensor  # (B, C, 3, 1000) int32: [lrt, flat, diff]

    def replace(self, **kw) -> "NsState":
        return dataclasses.replace(self, **kw)


def init_state(batch: int, num_channels: int, num_bands: int,
               device) -> NsState:
    b, c = batch, num_channels
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)

    def full(shape, v):
        return torch.full(shape, v, **f32)

    counter0 = np.floor(
        LONG_STARTUP_BLOCKS * (np.arange(NUM_SIMULT) + 1.0) / NUM_SIMULT
    ).astype(np.int32)
    return NsState(
        num_analyzed_frames=torch.full((b,), -1, **i32),
        analyze_analysis_memory=torch.zeros((b, c, OVERLAP), **f32),
        prev_analysis_signal_spectrum=full((b, c, NUM_BINS), 1.0),
        process_analysis_memory=torch.zeros((b, c, OVERLAP), **f32),
        process_synthesis_memory=torch.zeros((b, c, OVERLAP), **f32),
        process_delay_memory=torch.zeros(
            (b, c, max(num_bands - 1, 0), OVERLAP), **f32),
        white_noise_level=torch.zeros((b, c), **f32),
        pink_noise_numerator=torch.zeros((b, c), **f32),
        pink_noise_exp=torch.zeros((b, c), **f32),
        prev_noise_spectrum=torch.zeros((b, c, NUM_BINS), **f32),
        conservative_noise_spectrum=torch.zeros((b, c, NUM_BINS), **f32),
        parametric_noise_spectrum=torch.zeros((b, c, NUM_BINS), **f32),
        noise_spectrum=torch.zeros((b, c, NUM_BINS), **f32),
        density=full((b, c, NUM_SIMULT, NUM_BINS), 0.3),
        log_quantile=full((b, c, NUM_SIMULT, NUM_BINS), 8.0),
        quantile=torch.zeros((b, c, NUM_BINS), **f32),
        counter=torch.from_numpy(counter0).to(device).expand(
            b, c, NUM_SIMULT).clone(),
        num_updates=torch.ones((b, c), **i32),
        wiener_filter=full((b, c, NUM_BINS), 1.0),
        initial_spectral_estimate=torch.zeros((b, c, NUM_BINS), **f32),
        spectrum_prev_process=torch.zeros((b, c, NUM_BINS), **f32),
        prior_speech_prob=full((b, c), 0.5),
        speech_probability=torch.zeros((b, c, NUM_BINS), **f32),
        lrt=full((b, c), 0.5),
        spectral_flatness=full((b, c), 0.5),
        spectral_diff=full((b, c), 0.5),
        avg_log_lrt=full((b, c, NUM_BINS), 0.5),
        diff_normalization=torch.zeros((b, c), **f32),
        signal_energy_sum=torch.zeros((b, c), **f32),
        histogram_analysis_counter=torch.full(
            (b, c), FEATURE_UPDATE_WINDOW, **i32),
        prior_lrt=full((b, c), 0.5),
        prior_flatness_threshold=full((b, c), 0.5),
        prior_template_diff_threshold=full((b, c), 0.5),
        prior_lrt_weighting=full((b, c), 1.0),
        prior_flatness_weighting=torch.zeros((b, c), **f32),
        prior_difference_weighting=torch.zeros((b, c), **f32),
        histograms=torch.zeros((b, c, 3, HISTOGRAM_SIZE), **i32),
    )


def _bc(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Broadcast a per-stream (B,) value against ``like`` (B, ...)."""
    return v.reshape(v.shape + (1,) * (like.dim() - v.dim()))


def _magnitude_spectrum(spec):
    """ComputeMagnitudeSpectrum (noise_suppressor.cc:158-171): |X|+1, with
    DC/Nyquist using |Re| only."""
    mag = torch.abs(spec) + 1.0
    ends = torch.abs(spec.real) + 1.0
    mag = mag.clone()
    mag[..., 0] = ends[..., 0]
    mag[..., -1] = ends[..., -1]
    return mag


def _quantile_estimate(state: NsState, log_spectrum):
    """QuantileNoiseEstimator::Estimate (quantile_noise_estimator.cc:36-93).

    log_spectrum: (B, C, 129). Returns (state updates dict, noise_spectrum).
    """
    counter = state.counter  # (B, C, 3)
    cnt_f = counter.to(log_spectrum.dtype)
    one_by_cp1 = 1.0 / (cnt_f + 1.0)

    delta = torch.where(state.density > 1.0, 40.0 / state.density, 40.0)
    multiplier = delta * one_by_cp1[..., None]  # (B, C, 3, 129)
    ls = log_spectrum[:, :, None, :]
    above = ls > state.log_quantile
    log_quantile = state.log_quantile + torch.where(
        above, 0.25 * multiplier, -0.75 * multiplier
    )

    width = 0.01
    in_width = torch.abs(ls - log_quantile) < width
    density = torch.where(
        in_width,
        (cnt_f[..., None] * state.density + 1.0 / (2.0 * width))
        * one_by_cp1[..., None],
        state.density,
    )

    # Counter wrap: a slot whose counter reached 200 publishes its quantile
    # (largest such s wins) and resets; every slot then increments.
    expired = counter >= LONG_STARTUP_BLOCKS
    new_counter = torch.where(expired, 0, counter) + 1

    mature = state.num_updates >= LONG_STARTUP_BLOCKS  # (B, C)
    slot_ids = torch.arange(NUM_SIMULT, dtype=torch.int32,
                            device=counter.device)
    sel = torch.amax(torch.where(expired, slot_ids, -1), dim=-1)  # (B, C)
    has_sel = (sel >= 0) & mature
    startup = state.num_updates < LONG_STARTUP_BLOCKS
    sel = torch.where(startup, NUM_SIMULT - 1, sel)
    publish = has_sel | startup
    num_updates = torch.where(startup, state.num_updates + 1,
                              state.num_updates)

    slot_oh = slot_ids[:, None] == torch.clamp(sel, min=0)[..., None, None]
    chosen_lq = torch.sum(torch.where(slot_oh, log_quantile, 0.0), dim=2)
    quantile = torch.where(publish[..., None], exp_approx(chosen_lq),
                           state.quantile)

    updates = dict(
        density=density,
        log_quantile=log_quantile,
        quantile=quantile,
        counter=new_counter.to(torch.int32),
        num_updates=num_updates.to(torch.int32),
    )
    return updates, quantile


class NoiseSuppressor(nn.Module):
    """NoiseSuppressor::{Analyze, Process} (noise_suppressor.cc:286-528)."""

    def __init__(self, level: NoiseSuppressionLevel):
        super().__init__()
        self.params = SUPPRESSION_PARAMS[level]
        self.register_buffer("window", torch.from_numpy(_window()))
        self.register_buffer("log_table", torch.from_numpy(_log_table()))
        bins = np.maximum(np.arange(NUM_BINS, dtype=np.float32), 5.0)
        self.register_buffer("use_band", torch.from_numpy(bins))

    # ------------------------------------------------------------ analyze

    def _noise_pre_update(self, state: NsState, n, signal_spectrum,
                          spectral_sum):
        """NoiseEstimator::PreUpdate (noise_estimator.cc:70-156)."""
        params = self.params
        q_updates, noise = _quantile_estimate(state,
                                              log_approx(signal_spectrum))

        in_startup = _bc(n < SHORT_STARTUP_BLOCKS, spectral_sum)  # (B, 1)
        nf = _bc(n.to(signal_spectrum.dtype), spectral_sum)

        start_band = 5
        log_i = self.log_table[start_band:]
        sum_log_i = torch.sum(log_i)
        sum_log_i_sq = torch.sum(log_i ** 2)
        log_sig = log_approx(signal_spectrum[..., start_band:])
        sum_log_magn = torch.sum(log_sig, dim=-1)
        sum_log_i_log_magn = torch.sum(log_i * log_sig, dim=-1)

        white = state.white_noise_level + torch.where(
            in_startup,
            spectral_sum * (1.0 / NUM_BINS) * params.over_subtraction_factor,
            0.0,
        )

        denom = sum_log_i_sq * (NUM_BINS - start_band) - sum_log_i * sum_log_i
        num1 = sum_log_i_sq * sum_log_magn - sum_log_i * sum_log_i_log_magn
        adj1 = torch.clamp(num1 / denom, min=0.0)
        pink_num = state.pink_noise_numerator + torch.where(in_startup, adj1,
                                                            0.0)
        num2 = (sum_log_i * sum_log_magn
                - (NUM_BINS - start_band) * sum_log_i_log_magn)
        adj2 = torch.clamp(num2 / denom, 0.0, 1.0)
        pink_exp = state.pink_noise_exp + torch.where(in_startup, adj2, 0.0)

        one_by_np1 = 1.0 / (nf + 1.0)
        use_pink = pink_exp > 0.0
        parametric_num = exp_approx(pink_num * one_by_np1) * (nf + 1.0)
        parametric_exp = pink_exp * one_by_np1

        # PowApproximation(use_band, parametric_exp) per channel.
        parametric_denom = torch.exp2(
            parametric_exp[..., None] * fast_log2(self.use_band)
        )
        parametric = torch.where(
            use_pink[..., None],
            parametric_num[..., None] / parametric_denom,
            white[..., None] * torch.ones_like(parametric_denom),
        )
        parametric = torch.where(in_startup[..., None], parametric,
                                 state.parametric_noise_spectrum)

        # Weight quantile noise with the modeled noise during startup.
        blended = (
            noise * nf[..., None]
            + parametric * (SHORT_STARTUP_BLOCKS - nf[..., None])
            * one_by_np1[..., None]
        ) * (1.0 / SHORT_STARTUP_BLOCKS)
        noise = torch.where(in_startup[..., None], blended, noise)

        return dict(
            noise_spectrum=noise,
            parametric_noise_spectrum=parametric,
            white_noise_level=torch.where(in_startup, white,
                                          state.white_noise_level),
            pink_noise_numerator=torch.where(
                in_startup, pink_num, state.pink_noise_numerator),
            pink_noise_exp=torch.where(in_startup, pink_exp,
                                       state.pink_noise_exp),
            **q_updates,
        )

    def _speech_prob_update(self, state: NsState, n, prior_snr, post_snr,
                            signal_spectrum, spectral_sum, energy):
        """SpeechProbabilityEstimator::Update + SignalModelEstimator::Update
        (speech_probability_estimator.cc:31-109,
        signal_model_estimator.cc:126-178), on the pre-PostUpdate
        conservative noise spectrum."""
        dt = signal_spectrum.dtype
        nf = _bc(n.to(dt), spectral_sum)
        updates = {}

        # AdjustNormalization (signal_model_estimator.cc:118-123).
        diff_norm = torch.where(
            _bc(n < LONG_STARTUP_BLOCKS, spectral_sum),
            (state.diff_normalization * nf + energy) / (nf + 1.0),
            state.diff_normalization,
        )

        # UpdateSpectralFlatness (signal_model_estimator.cc:73-103).
        k_averaging = 0.3
        upper = signal_spectrum[..., 1:]
        has_zero = torch.any(upper == 0.0, dim=-1)
        safe = torch.where(upper == 0.0, 1.0, upper)
        num = torch.sum(log_approx(safe), dim=-1) * (1.0 / NUM_BINS)
        den = (spectral_sum - signal_spectrum[..., 0]) * (1.0 / NUM_BINS)
        flat_tmp = exp_approx(num) / den
        flatness = torch.where(
            has_zero,
            state.spectral_flatness - k_averaging * state.spectral_flatness,
            state.spectral_flatness
            + k_averaging * (flat_tmp - state.spectral_flatness),
        )
        updates["spectral_flatness"] = flatness

        # ComputeSpectralDiff (signal_model_estimator.cc:30-70).
        cons = state.conservative_noise_spectrum
        noise_avg = torch.mean(cons, dim=-1)
        signal_avg = spectral_sum * (1.0 / NUM_BINS)
        sig_d = signal_spectrum - signal_avg[..., None]
        noi_d = cons - noise_avg[..., None]
        covariance = torch.mean(sig_d * noi_d, dim=-1)
        noise_var = torch.mean(noi_d * noi_d, dim=-1)
        signal_var = torch.mean(sig_d * sig_d, dim=-1)
        sdiff = signal_var - covariance ** 2 / (noise_var + 1e-4)
        sdiff = sdiff / (diff_norm + 1e-4)
        spectral_diff = state.spectral_diff + 0.3 * (sdiff - state.spectral_diff)
        updates["spectral_diff"] = spectral_diff

        energy_sum = state.signal_energy_sum + energy

        # Histogram / prior-model 500-frame cycle
        # (signal_model_estimator.cc:155-172).
        counter = state.histogram_analysis_counter - 1
        do_hist = counter > 0  # (B, C)
        do_prior = torch.logical_not(do_hist)

        hist = state.histograms
        feats = torch.stack([state.lrt, flatness, spectral_diff], dim=-1)
        bin_sizes = const((BIN_SIZE_LRT, BIN_SIZE_SPEC_FLAT,
                           BIN_SIZE_SPEC_DIFF), dt, feats.device)
        bin_idx = (feats * (1.0 / bin_sizes)).to(torch.int32)
        valid = (feats >= 0.0) & (feats < HISTOGRAM_SIZE * bin_sizes)
        hist_bins = torch.arange(HISTOGRAM_SIZE, device=feats.device)
        incr = (valid & do_hist[..., None])[..., None] & (
            hist_bins == torch.clamp(bin_idx, 0, HISTOGRAM_SIZE - 1)[..., None]
        )
        hist_updated = hist + incr.to(torch.int32)

        prior = self._prior_model_update(state)  # histograms BEFORE this frame
        for k, v in prior.items():
            updates[k] = torch.where(do_prior, v, getattr(state, k))
        updates["histograms"] = torch.where(
            do_prior[..., None, None], torch.zeros_like(hist), hist_updated
        )
        updates["histogram_analysis_counter"] = torch.where(
            do_prior, FEATURE_UPDATE_WINDOW, counter
        ).to(torch.int32)
        diff_norm = torch.where(
            do_prior,
            0.5 * (energy_sum / FEATURE_UPDATE_WINDOW + diff_norm),
            diff_norm,
        )
        updates["diff_normalization"] = diff_norm
        updates["signal_energy_sum"] = torch.where(do_prior, 0.0, energy_sum)

        # UpdateSpectralLrt (signal_model_estimator.cc:106-124).
        tmp1 = 1.0 + 2.0 * prior_snr
        tmp2 = 2.0 * prior_snr / (tmp1 + 1e-4)
        bessel = (post_snr + 1.0) * tmp2
        avg_log_lrt = state.avg_log_lrt + 0.5 * (
            bessel - log_approx(tmp1) - state.avg_log_lrt
        )
        lrt = torch.mean(avg_log_lrt, dim=-1)
        updates["avg_log_lrt"] = avg_log_lrt
        updates["lrt"] = lrt

        # Indicator fusion (speech_probability_estimator.cc:50-96).
        k_w0, k_w1 = 4.0, 8.0
        prior_lrt = updates["prior_lrt"]
        prior_flat_thr = updates["prior_flatness_threshold"]
        prior_diff_thr = updates["prior_template_diff_threshold"]

        w = torch.where(lrt < prior_lrt, k_w1, k_w0)
        ind0 = 0.5 * (torch.tanh(w * (lrt - prior_lrt)) + 1.0)
        w = torch.where(flatness > prior_flat_thr, k_w1, k_w0)
        ind1 = 0.5 * (torch.tanh(w * (prior_flat_thr - flatness)) + 1.0)
        w = torch.where(spectral_diff < prior_diff_thr, k_w1, k_w0)
        ind2 = 0.5 * (torch.tanh(w * (spectral_diff - prior_diff_thr)) + 1.0)

        ind_prior = (
            updates["prior_lrt_weighting"] * ind0
            + updates["prior_flatness_weighting"] * ind1
            + updates["prior_difference_weighting"] * ind2
        )
        prior_prob = state.prior_speech_prob + 0.1 * (
            ind_prior - state.prior_speech_prob
        )
        prior_prob = torch.clamp(prior_prob, 0.01, 1.0)
        updates["prior_speech_prob"] = prior_prob

        gain_prior = (1.0 - prior_prob) / (prior_prob + 1e-4)
        inv_lrt = exp_approx(-avg_log_lrt)
        updates["speech_probability"] = 1.0 / (
            1.0 + gain_prior[..., None] * inv_lrt
        )
        return updates

    @staticmethod
    def _find_first_of_two_largest_peaks(hist, bin_size):
        """FindFirstOfTwoLargestPeaks (prior_signal_model_estimator.cc:33-76):
        peak = first argmax; secondary = first argmax with the peak's bin
        removed; merge if close and comparable. hist: (B, C, 1000)."""
        dt = torch.float32
        idx = torch.argmax(hist, dim=-1)
        val = torch.amax(hist, dim=-1)
        bins = torch.arange(hist.shape[-1], device=hist.device)
        masked = torch.where(bins == idx[..., None], -1, hist)
        idx2 = torch.argmax(masked, dim=-1)
        val2 = torch.amax(masked, dim=-1)

        pos = torch.where(val > 0, (idx.to(dt) + 0.5) * bin_size, 0.0)
        weight = torch.where(val > 0, val, 0)
        pos2 = torch.where(val2 > 0, (idx2.to(dt) + 0.5) * bin_size, 0.0)
        weight2 = torch.where(val2 > 0, val2, 0)

        merge = (torch.abs(pos2 - pos) < 2 * bin_size) & (
            weight2.to(dt) > 0.5 * weight.to(dt)
        )
        weight = torch.where(merge, weight + weight2, weight)
        pos = torch.where(merge, 0.5 * (pos + pos2), pos)
        return pos, weight

    def _prior_model_update(self, state: NsState):
        """PriorSignalModelEstimator::Update
        (prior_signal_model_estimator.cc:137-188), from the current
        histograms; the caller gates it by the 500-frame cycle."""
        dt = state.lrt.dtype
        lrt_hist = state.histograms[:, :, 0]  # (B, C, 1000)
        flat_hist = state.histograms[:, :, 1]
        diff_hist = state.histograms[:, :, 2]

        bin_mid = (torch.arange(HISTOGRAM_SIZE, dtype=dt,
                                device=state.lrt.device) + 0.5) * BIN_SIZE_LRT
        count10 = torch.sum(lrt_hist[..., :10], dim=-1).to(dt)
        avg10 = torch.sum(lrt_hist[..., :10].to(dt) * bin_mid[:10], dim=-1)
        average = torch.where(count10 > 0,
                              avg10 / torch.clamp(count10, min=1.0), 0.0)

        hist_f = lrt_hist.to(dt)
        average_squared = (torch.sum(hist_f * bin_mid ** 2, dim=-1)
                           / FEATURE_UPDATE_WINDOW)
        average_compl = (torch.sum(hist_f * bin_mid, dim=-1)
                         / FEATURE_UPDATE_WINDOW)

        low_lrt_fluctuations = average_squared - average * average_compl < 0.05
        prior_lrt = torch.where(low_lrt_fluctuations, 1.0,
                                torch.clamp(1.2 * average, 0.2, 1.0))

        flat_pos, flat_weight = self._find_first_of_two_largest_peaks(
            flat_hist, BIN_SIZE_SPEC_FLAT)
        diff_pos, diff_weight = self._find_first_of_two_largest_peaks(
            diff_hist, BIN_SIZE_SPEC_DIFF)

        use_flat = torch.logical_not(
            (flat_weight.to(dt) < 0.3 * 500) | (flat_pos < 0.6))
        use_diff = torch.logical_not(
            (diff_weight.to(dt) < 0.3 * 500) | low_lrt_fluctuations)

        template_diff_threshold = torch.clamp(1.2 * diff_pos, 0.16, 1.0)
        one_by_sum = 1.0 / (1.0 + use_flat.to(dt) + use_diff.to(dt))
        flatness_threshold = torch.where(
            use_flat, torch.clamp(0.9 * flat_pos, 0.1, 0.95),
            state.prior_flatness_threshold,
        )
        return dict(
            prior_lrt=prior_lrt,
            prior_flatness_threshold=flatness_threshold,
            prior_template_diff_threshold=template_diff_threshold,
            prior_lrt_weighting=one_by_sum,
            prior_flatness_weighting=torch.where(use_flat, one_by_sum, 0.0),
            prior_difference_weighting=torch.where(use_diff, one_by_sum, 0.0),
        )

    def analyze(self, state: NsState, band0: torch.Tensor) -> NsState:
        """NoiseSuppressor::Analyze (noise_suppressor.cc:286-364).

        band0: (B, 160, C) band-0 frame in floatS16. A stream whose frame
        and memory are all zero keeps its state (noise_suppressor.cc:294-318).
        """
        x = band0.transpose(1, 2)  # (B, C, 160)
        energy_all = (torch.sum(state.analyze_analysis_memory ** 2, dim=(1, 2))
                      + torch.sum(x ** 2, dim=(1, 2)))
        zero_frame = energy_all <= 0.0  # (B,)

        n = state.num_analyzed_frames + 1
        n = torch.where(n < 0, 0, n)

        extended = torch.cat([state.analyze_analysis_memory, x], dim=-1)
        new_memory = extended[..., -OVERLAP:]
        windowed = extended * self.window
        spec = mxu_fft.rfft(windowed, FFT_SIZE)
        signal_spectrum = _magnitude_spectrum(spec).to(x.dtype)
        signal_energy = (
            torch.sum(spec.real ** 2 + spec.imag ** 2, dim=-1).to(x.dtype)
            / NUM_BINS
        )
        spectral_sum = torch.sum(signal_spectrum, dim=-1)

        # PrepareAnalysis (noise_estimator.cc:63-67).
        prev_noise = state.noise_spectrum
        new = state.replace(prev_noise_spectrum=prev_noise)

        pre = self._noise_pre_update(new, n, signal_spectrum, spectral_sum)
        new = new.replace(**pre)

        prior_snr, post_snr = _compute_snr(
            new.wiener_filter, new.prev_analysis_signal_spectrum,
            signal_spectrum, prev_noise, new.noise_spectrum,
        )
        sp = self._speech_prob_update(new, n, prior_snr, post_snr,
                                      signal_spectrum, spectral_sum,
                                      signal_energy)
        new = new.replace(**sp)

        new_noise, new_cons = _noise_post_update(
            new.prev_noise_spectrum, new.conservative_noise_spectrum,
            new.speech_probability, signal_spectrum,
        )
        new = new.replace(
            num_analyzed_frames=n.to(torch.int32),
            analyze_analysis_memory=new_memory,
            prev_analysis_signal_spectrum=signal_spectrum,
            noise_spectrum=new_noise,
            conservative_noise_spectrum=new_cons,
        )
        return NsState(**{
            f.name: torch.where(
                _bc(zero_frame, getattr(new, f.name)),
                getattr(state, f.name), getattr(new, f.name))
            for f in dataclasses.fields(NsState)
        })

    # ------------------------------------------------------------ process

    def _wiener_update(self, state: NsState, n, signal_spectrum):
        """WienerFilter::Update (wiener_filter.cc:33-86)."""
        params = self.params
        dt = signal_spectrum.dtype
        prev_tsa = (
            state.spectrum_prev_process
            / (state.prev_noise_spectrum + 1e-4)
            * state.wiener_filter
        )
        current_tsa = torch.where(
            signal_spectrum > state.noise_spectrum,
            signal_spectrum / (state.noise_spectrum + 1e-4) - 1.0,
            0.0,
        )
        snr_prior = 0.98 * prev_tsa + 0.02 * current_tsa
        filt = snr_prior / (params.over_subtraction_factor + snr_prior)
        filt = torch.clamp(filt, params.minimum_attenuating_gain, 1.0)

        in_startup = _bc(n < SHORT_STARTUP_BLOCKS, signal_spectrum)
        nf = _bc(n.to(dt), signal_spectrum)
        initial_est = state.initial_spectral_estimate + torch.where(
            in_startup, signal_spectrum, 0.0
        )
        filt_initial = (
            initial_est
            - params.over_subtraction_factor * state.parametric_noise_spectrum
        ) / (initial_est + 1e-4)
        filt_initial = torch.clamp(filt_initial,
                                   params.minimum_attenuating_gain, 1.0)
        blended = (
            filt * nf + filt_initial * (SHORT_STARTUP_BLOCKS - nf)
        ) * (1.0 / SHORT_STARTUP_BLOCKS)
        filt = torch.where(in_startup, blended, filt)
        return dict(
            wiener_filter=filt,
            initial_spectral_estimate=initial_est,
            spectrum_prev_process=signal_spectrum,
        )

    def _overall_scaling(self, n, prior_prob, e_before, e_after):
        """WienerFilter::ComputeOverallScalingFactor (wiener_filter.cc:88-123).
        Per (B, C); n is (B,)."""
        params = self.params
        gain = torch.sqrt(e_after / (e_before + 1.0))
        k_b_lim = 0.5
        sf1 = torch.where(gain > k_b_lim, 1.0 + 1.3 * (gain - k_b_lim), 1.0)
        sf1 = torch.where((gain > k_b_lim) & (gain * sf1 > 1.0), 1.0 / gain,
                          sf1)
        gain_floored = torch.clamp(gain, min=params.minimum_attenuating_gain)
        sf2 = torch.where(gain < k_b_lim,
                          1.0 - 0.3 * (k_b_lim - gain_floored), 1.0)
        scale = prior_prob * sf1 + (1.0 - prior_prob) * sf2
        if not params.use_attenuation_adjustment:
            return torch.ones_like(scale)
        return torch.where(_bc(n > LONG_STARTUP_BLOCKS, scale), scale, 1.0)

    def _compute_upper_bands_gain(self, filt, speech_prob, prev_spectrum,
                                  signal_spectrum):
        """ComputeUpperBandsGain (noise_suppressor.cc:202-252), (B, C)."""
        params = self.params
        avg_prob = torch.mean(
            speech_prob[..., NUM_BINS - 33: NUM_BINS - 1], dim=-1)
        avg_gain = torch.mean(filt[..., NUM_BINS - 33: NUM_BINS - 1], dim=-1)
        sum_analysis = torch.sum(prev_spectrum, dim=-1)
        sum_processing = torch.sum(signal_spectrum, dim=-1)
        avg_prob = avg_prob * sum_processing / sum_analysis
        gain = 0.5 * (1.0 + torch.tanh(2.0 * avg_prob - 1.0))
        gain = torch.where(
            avg_prob >= 0.5,
            0.25 * gain + 0.75 * avg_gain,
            0.5 * gain + 0.5 * avg_gain,
        )
        return torch.clamp(gain, params.minimum_attenuating_gain, 1.0)

    def process(self, state: NsState, bands: torch.Tensor):
        """NoiseSuppressor::Process (noise_suppressor.cc:366-528).

        bands: (B, num_bands, 160, C) floatS16. Returns (state, new_bands).
        """
        num_bands = bands.shape[1]
        x = bands[:, 0].transpose(1, 2)  # (B, C, 160)
        n = state.num_analyzed_frames

        extended = torch.cat([state.process_analysis_memory, x], dim=-1)
        new_analysis_memory = extended[..., -OVERLAP:]
        windowed = extended * self.window
        e_before = torch.sum(windowed ** 2, dim=-1)
        spec = mxu_fft.rfft(windowed, FFT_SIZE)
        signal_spectrum = _magnitude_spectrum(spec).to(x.dtype)

        wiener = self._wiener_update(state, n, signal_spectrum)
        state = state.replace(process_analysis_memory=new_analysis_memory,
                              **wiener)

        if num_bands > 1:
            upper_gain = torch.amin(
                self._compute_upper_bands_gain(
                    state.wiener_filter, state.speech_probability,
                    state.prev_analysis_signal_spectrum, signal_spectrum,
                ),
                dim=1,
            )  # (B,)

        # Aggregate the per-channel Wiener filters (noise_suppressor.cc:270-284).
        filt = torch.amin(state.wiener_filter, dim=1)  # (B, 129)

        filtered = spec * filt[:, None, :]
        ext = mxu_fft.irfft(filtered, FFT_SIZE).to(x.dtype)
        e_after = torch.sum(ext ** 2, dim=-1)
        ext = ext * self.window

        gain_adj = torch.amin(
            self._overall_scaling(n, state.prior_speech_prob, e_before,
                                  e_after),
            dim=1,
        )  # (B,)
        ext = ext * gain_adj[:, None, None]

        out0 = torch.cat(
            [state.process_synthesis_memory + ext[..., :OVERLAP],
             ext[..., OVERLAP:FRAME_SIZE]],
            dim=-1,
        )
        state = state.replace(process_synthesis_memory=ext[..., FRAME_SIZE:])

        out_bands = [out0.transpose(1, 2)]
        if num_bands > 1:
            # Delay upper bands by 96 samples and apply the time-domain gain
            # (noise_suppressor.cc:480-505, DelaySignal :119-131).
            new_delay = []
            for b in range(1, num_bands):
                xb = bands[:, b].transpose(1, 2)  # (B, C, 160)
                delayed = torch.cat(
                    [state.process_delay_memory[:, :, b - 1],
                     xb[..., : FRAME_SIZE - OVERLAP]],
                    dim=-1,
                )
                new_delay.append(xb[..., FRAME_SIZE - OVERLAP:])
                out_bands.append(
                    (upper_gain[:, None, None] * delayed).transpose(1, 2))
            state = state.replace(
                process_delay_memory=torch.stack(new_delay, dim=2))

        out = torch.stack(out_bands, dim=1)
        return state, torch.clamp(out, -32768.0, 32767.0)

    def forward(self, state: NsState, bands: torch.Tensor):
        """Analyze band 0, then process all bands (the desktop order of
        audio_processing_impl.cc:1387-1425 with no echo canceller between)."""
        state = self.analyze(state, bands[:, 0])
        return self.process(state, bands)


def _noise_post_update(prev_noise, conservative, speech_prob,
                       signal_spectrum):
    """NoiseEstimator::PostUpdate (noise_estimator.cc:159-206).

    The reference carries ``gamma`` across the bin loop; gamma entering bin
    i is 0.9 for i=0 and otherwise set by bin i-1's speech probability, so
    the chain vectorizes as a shifted select.
    """
    k_noise_update = 0.9
    prob = speech_prob
    gamma = torch.where(prob > 0.2, 0.99, k_noise_update)
    gamma_prev = torch.cat(
        [torch.full_like(gamma[..., :1], k_noise_update), gamma[..., :-1]],
        dim=-1,
    )
    blend = (1.0 - prob) * signal_spectrum + prob * prev_noise
    tmp = gamma_prev * prev_noise + (1.0 - gamma_prev) * blend
    cur = gamma * prev_noise + (1.0 - gamma) * blend
    new_noise = torch.where(gamma == gamma_prev, tmp, torch.minimum(cur, tmp))

    new_conservative = torch.where(
        prob < 0.2,
        conservative + 0.05 * (signal_spectrum - conservative),
        conservative,
    )
    return new_noise, new_conservative


def _compute_snr(filt, prev_signal, signal, prev_noise, noise):
    """ComputeSnr (noise_suppressor.cc:174-199)."""
    prev_estimate = prev_signal / (prev_noise + 1e-4) * filt
    post_snr = torch.clamp(signal / (noise + 1e-4) - 1.0, min=0.0)
    post_snr = torch.where(signal > noise, post_snr, 0.0)
    prior_snr = 0.98 * prev_estimate + 0.02 * post_snr
    return prior_snr, post_snr
