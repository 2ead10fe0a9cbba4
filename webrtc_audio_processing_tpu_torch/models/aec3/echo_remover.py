"""AEC3 echo remover: subtraction -> state -> CNG -> residual -> suppression.

Port of ``webrtc_audio_processing_tpu/models/aec3/echo_remover.py``
(reference: aec3/echo_remover.cc, comfort_noise_generator.cc,
residual_echo_estimator.cc, suppression_gain.cc with
dominant_nearend_detector.cc and moving_average.cc, suppression_filter.cc).
The main path runs ``process_capture_pair``, all capture blocks of one frame
in three phases; the per-block ``process_capture`` is not ported.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass

import numpy as np
import torch

from webrtc_audio_processing_tpu_torch.models.aec3 import (
    aec_state as aecs,
    fft as afft,
    render_buffer as rb,
    reverb_decay_estimator as rde,
    subtractor as subt,
    subtractor_kernel,
)
from webrtc_audio_processing_tpu_torch.models.aec3.config import (
    EchoCanceller3Config,
)
from webrtc_audio_processing_tpu_torch.ops.batch import take, tree_where

NUM_BINS = 65
BLOCK_SIZE = 64
_I32 = torch.int32

# sqrt(2)*sin(2*pi*i/32) table (comfort_noise_generator.cc:40-50).
SQRT2_SIN = (np.sqrt(2.0) * np.sin(2.0 * np.pi * np.arange(32) / 32.0)
             ).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _lcg_tables(n_rand: int, device: torch.device):
    """seed_k = (A_k seed_0 + B_k) mod 2^31 for the k-th step of the
    comfort-noise LCG seed' = (69069 seed + 1) mod 2^31, k = 1..n_rand, and
    the sine table; int64 keeps A_k * seed exact."""
    A = np.empty(n_rand, np.int64)
    Bc = np.empty(n_rand, np.int64)
    a_k, b_k = 1, 0
    for k in range(n_rand):
        a_k = (a_k * 69069) % (1 << 31)
        b_k = (b_k * 69069 + 1) % (1 << 31)
        A[k], Bc[k] = a_k, b_k
    return (torch.from_numpy(A).to(device), torch.from_numpy(Bc).to(device),
            torch.from_numpy(SQRT2_SIN).to(device))


# ------------------------------------------------------------- comfort noise


@dataclass
class ComfortNoiseState:
    seed: torch.Tensor  # (B,) uint32
    N2_initial: torch.Tensor  # (B, C, 65)
    Y2_smoothed: torch.Tensor  # (B, C, 65)
    N2: torch.Tensor  # (B, C, 65)
    N2_counter: torch.Tensor  # (B,) int32


def init_comfort_noise(num_capture, batch, device) -> ComfortNoiseState:
    s = (batch, num_capture, NUM_BINS)
    return ComfortNoiseState(
        seed=torch.full((batch,), 42, dtype=torch.int64,
                        device=device).to(torch.uint32),
        N2_initial=torch.zeros(s, dtype=torch.float32, device=device),
        Y2_smoothed=torch.zeros(s, dtype=torch.float32, device=device),
        N2=torch.full(s, 1.0e6, dtype=torch.float32, device=device),
        N2_counter=torch.zeros((batch,), dtype=_I32, device=device),
    )


def comfort_noise_compute(config: EchoCanceller3Config,
                          state: ComfortNoiseState, saturated, Y2):
    """ComfortNoiseGenerator::Compute (comfort_noise_generator.cc:124-184).
    saturated (B,) bool, Y2 (B, C, 65). Returns (state, N_low, N_high,
    N2 used), the first two (B, C, 65) complex."""
    noise_floor = 64.0 * 10.0 ** (
        (90.30899869919436 + config.comfort_noise.noise_floor_dbfs) * 0.1)
    upd = ~saturated
    upd3 = upd[:, None, None]
    Y2s = torch.where(upd3, state.Y2_smoothed + 0.1 * (Y2 - state.Y2_smoothed),
                      state.Y2_smoothed)
    N2 = torch.where(
        (upd & (state.N2_counter > 50))[:, None, None],
        torch.where(Y2s < state.N2, (0.9 * Y2s + 0.1 * state.N2) * 1.0002,
                    state.N2 * 1.0002),
        state.N2)
    counter = torch.where(upd, state.N2_counter + 1, state.N2_counter)
    in_initial = (counter < 1000)[:, None, None]
    N2_init = torch.where(
        upd3 & in_initial,
        torch.where(N2 > state.N2_initial,
                    state.N2_initial + 0.001 * (N2 - state.N2_initial), N2),
        state.N2_initial)
    N2 = torch.where(upd3, torch.clamp(N2, min=noise_floor), N2)
    N2_init = torch.where(upd3 & in_initial,
                          torch.clamp(N2_init, min=noise_floor), N2_init)
    N2_used = torch.where(in_initial, N2_init, N2)

    # GenerateComfortNoise (:51-101): the LCG's per-bin random phases in
    # closed form, seed_k = (A_k seed_0 + B_k) mod 2^31.
    B, C = Y2.shape[:2]
    A, Bc, table = _lcg_tables(C * 63, Y2.device)
    seq = (A * state.seed.to(torch.int64)[:, None] + Bc) & 0x7FFFFFFF
    idx = (seq >> 26).reshape(B, C, 63)
    x = table[idx]
    y = table[(idx + 8) & 31]

    N = torch.sqrt(N2_used)
    hi_level = torch.sum(N[..., 32:], dim=-1) * (1.0 / 34.0)
    zeros = torch.zeros((B, C, 1), dtype=torch.float32, device=Y2.device)
    N_low = torch.complex(torch.cat([zeros, N[..., 1:64] * x, zeros], -1),
                          torch.cat([zeros, N[..., 1:64] * y, zeros], -1))
    N_high = torch.complex(
        torch.cat([zeros, hi_level[..., None] * x, zeros], -1),
        torch.cat([zeros, hi_level[..., None] * y, zeros], -1))
    new_state = ComfortNoiseState(
        seed=seq[:, -1].to(torch.uint32), N2_initial=N2_init,
        Y2_smoothed=Y2s, N2=N2, N2_counter=counter.to(_I32))
    return new_state, N_low, N_high, N2_used


# -------------------------------------------------------- residual echo


@dataclass
class ResidualEchoState:
    echo_reverb: aecs.ReverbModelState
    X2_noise_floor: torch.Tensor  # (B, 65)
    X2_noise_floor_counter: torch.Tensor  # (B, 65) int32

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def init_residual_echo(config, batch, device) -> ResidualEchoState:
    return ResidualEchoState(
        echo_reverb=aecs.ReverbModelState(reverb=torch.zeros(
            (batch, NUM_BINS), dtype=torch.float32, device=device)),
        X2_noise_floor=torch.full((batch, NUM_BINS),
                                  config.echo_model.min_noise_floor_power,
                                  dtype=torch.float32, device=device),
        X2_noise_floor_counter=torch.full(
            (batch, NUM_BINS), config.echo_model.noise_floor_hold,
            dtype=_I32, device=device),
    )


def _channel_sum(X2):
    """Render spectra summed over render channels (channel 0 when mono)."""
    return X2[..., 0, :] if X2.shape[-2] == 1 else torch.sum(X2, dim=-2)


def residual_echo_estimate(config: EchoCanceller3Config,
                           state: ResidualEchoState, aec, S2_linear, Y2,
                           dominant_nearend, transparent_active,
                           filter_length_blocks, spec_win):
    """ResidualEchoEstimator::Estimate (residual_echo_estimator.cc:180-279)
    reading the spectra window spec_win (B, W, C_ren, 65). S2_linear and Y2
    (B, C, 65); dominant_nearend, transparent_active, filter_length_blocks
    (B,). Returns (state, R2, R2_unbounded), both (B, C, 65)."""
    em = config.echo_model

    # UpdateRenderNoisePower (:287-320).
    X2_now = _channel_sum(spec_win[:, 0])
    lower = X2_now < state.X2_noise_floor
    inc = state.X2_noise_floor_counter >= em.noise_floor_hold
    floor = torch.where(
        lower, X2_now,
        torch.where(inc, torch.clamp(state.X2_noise_floor * 1.1,
                                     min=em.min_noise_floor_power),
                    state.X2_noise_floor))
    floor_counter = torch.where(
        lower, 0, torch.where(inc, state.X2_noise_floor_counter,
                              state.X2_noise_floor_counter + 1))

    usable = aec.usable_linear_estimate[:, None, None]
    saturated_echo = aec.saturated_echo[:, None, None]
    min_delay = aec.min_filter_delay

    # Linear branch.
    onset_comp = (config.ep_strength.erle_onset_compensation_in_dominant_nearend
                  | ~dominant_nearend)
    erle_plain, erle_oc, erle_unb = aecs.erle_arrays(config, aec.erle)
    erle = torch.where(onset_comp[:, None, None], erle_oc, erle_plain)
    R2_lin = S2_linear / torch.clamp(erle, min=1e-30)
    R2_lin_unb = S2_linear / torch.clamp(erle_unb, min=1e-30)

    # Nonlinear branch: EchoGeneratingPower (:119-150), the max over a
    # window around the delay.
    gain_amp = torch.where(transparent_active, 0.01,
                           config.ep_strength.default_gain)
    echo_path_gain = gain_amp * gain_amp
    pre, post = em.render_pre_window_size, em.render_post_window_size
    offsets = torch.arange(-pre, post + 1, device=Y2.device)
    start = torch.clamp(min_delay - pre, min=0)
    offs = torch.minimum(torch.maximum(min_delay[:, None] + offsets,
                                       start[:, None]),
                         (min_delay + post)[:, None])
    X2 = torch.max(_channel_sum(take(spec_win, offs)), dim=1)[0]
    # ApplyNoiseGate (:105-113).
    ng = em.noise_gate_power
    X2 = torch.where(ng > X2,
                     torch.clamp(X2 - em.noise_gate_slope * (ng - X2),
                                 min=0.0), X2)
    X2 = torch.clamp(X2 - em.stationary_gate_slope * floor, min=0.0)
    R2_nonlin = (X2 * echo_path_gain[:, None])[:, None, :].expand_as(
        S2_linear)

    R2 = torch.where(usable, R2_lin, R2_nonlin)
    R2_unbounded = torch.where(usable, R2_lin_unb, R2_nonlin)
    R2 = torch.where(saturated_echo, Y2, R2)
    R2_unbounded = torch.where(saturated_echo, Y2, R2_unbounded)

    # Reverb (UpdateReverb + AddReverb, :322-377).
    decay = rde.decay_value(config, aec.reverb_decay_est, dominant_nearend)
    first_partition = torch.where(aec.usable_linear_estimate,
                                  filter_length_blocks + 1, min_delay + 1)
    render_power = _channel_sum(take(spec_win, first_partition))
    lin_reverb = aecs.reverb_update(
        state.echo_reverb, render_power,
        aec.reverb_freq_response.tail_response[:, 0], decay)
    late_gain = torch.where(transparent_active, 0.01,
                            config.ep_strength.default_gain) ** 2
    nonlin_reverb = aecs.reverb_update(state.echo_reverb, render_power,
                                       late_gain[:, None], decay)
    add_reverb_nonlin = (bool(em.model_reverb_in_nonlinear_mode)
                         & ~transparent_active)
    reverb = tree_where(
        aec.usable_linear_estimate, lin_reverb,
        tree_where(add_reverb_nonlin, nonlin_reverb, state.echo_reverb))
    add = (aec.usable_linear_estimate | add_reverb_nonlin)[:, None, None]
    R2 = R2 + torch.where(add, reverb.reverb[:, None, :], 0.0)
    R2_unbounded = R2_unbounded + torch.where(add, reverb.reverb[:, None, :],
                                              0.0)

    # Echo-audibility residual scaling (residual_echo_estimator.cc:300-310).
    if config.echo_audibility.use_stationarity_properties:
        scaling = aecs.residual_echo_scaling(config, aec)[:, None, :]
        R2 = R2 * scaling
        R2_unbounded = R2_unbounded * scaling

    return (
        state.replace(echo_reverb=reverb, X2_noise_floor=floor,
                      X2_noise_floor_counter=floor_counter.to(_I32)),
        R2,
        R2_unbounded,
    )


# ------------------------------------------------------- suppression gain


@functools.lru_cache(maxsize=None)
def _gain_parameters(last_lf: int, first_hf: int, tuning, device):
    """GainParameters (suppression_gain.cc:427-450): the enr/emr thresholds
    interpolated from the low- to the high-frequency masking values."""
    k = np.arange(NUM_BINS, dtype=np.float32)
    a = np.clip((k - last_lf) / float(first_hf - last_lf), 0.0, 1.0)
    a[k <= last_lf] = 0.0
    a[k >= first_hf] = 1.0
    lf, hf = tuning.mask_lf, tuning.mask_hf

    def mix(lo, hi):
        return torch.from_numpy(
            ((1 - a) * lo + a * hi).astype(np.float32)).to(device)

    return dict(
        enr_transparent=mix(lf.enr_transparent, hf.enr_transparent),
        enr_suppress=mix(lf.enr_suppress, hf.enr_suppress),
        emr_transparent=mix(lf.emr_transparent, hf.emr_transparent),
        max_inc_factor=tuning.max_inc_factor,
        max_dec_factor_lf=tuning.max_dec_factor_lf,
    )


@dataclass
class SuppressionGainState:
    last_gain: torch.Tensor  # (B, 65)
    last_nearend: torch.Tensor  # (B, C, 65)
    last_echo: torch.Tensor  # (B, C, 65)
    initial_state: torch.Tensor  # (B,) bool
    initial_state_change_counter: torch.Tensor  # (B,) int32
    nearend_memory: torch.Tensor  # (B, C, mem, 65) MovingAverage memory
    nearend_mem_index: torch.Tensor  # (B,) int32
    average_power: torch.Tensor  # (B,) LowNoiseRenderDetector
    dn_trigger_counters: torch.Tensor  # (B, C) int32
    dn_hold_counters: torch.Tensor  # (B, C) int32
    dn_nearend_state: torch.Tensor  # (B,) bool

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def init_suppression_gain(config, num_capture, batch,
                          device) -> SuppressionGainState:
    mem = max(config.suppressor.nearend_average_blocks - 1, 0)
    f32 = dict(dtype=torch.float32, device=device)
    bc = (batch, num_capture)
    return SuppressionGainState(
        last_gain=torch.ones((batch, NUM_BINS), **f32),
        last_nearend=torch.zeros(bc + (NUM_BINS,), **f32),
        last_echo=torch.zeros(bc + (NUM_BINS,), **f32),
        initial_state=torch.ones((batch,), dtype=torch.bool, device=device),
        initial_state_change_counter=torch.zeros((batch,), dtype=_I32,
                                                 device=device),
        nearend_memory=torch.zeros(bc + (mem, NUM_BINS), **f32),
        nearend_mem_index=torch.zeros((batch,), dtype=_I32, device=device),
        average_power=torch.full((batch,), 32768.0 * 32768.0, **f32),
        dn_trigger_counters=torch.zeros(bc, dtype=_I32, device=device),
        dn_hold_counters=torch.zeros(bc, dtype=_I32, device=device),
        dn_nearend_state=torch.zeros((batch,), dtype=torch.bool,
                                     device=device),
    )


def _weight_echo_for_audibility(config, echo):
    """WeightEchoForAudibility (suppression_gain.cc:75-105). echo (..., 65)."""
    ea = config.echo_audibility
    k = torch.arange(NUM_BINS, device=echo.device)
    thr = torch.where(
        k < 3, ea.floor_power * ea.audibility_threshold_lf,
        torch.where(k < 7, ea.floor_power * ea.audibility_threshold_mf,
                    ea.floor_power * ea.audibility_threshold_hf)
    ).to(torch.float32)
    norm = 1.0 / (thr - ea.floor_power)
    tmp = (thr - echo) * norm
    return torch.where(echo < thr,
                       echo * torch.clamp(1.0 - tmp * tmp, min=0.0), echo)


def suppression_gain_compute(config: EchoCanceller3Config,
                             state: SuppressionGainState, nearend_spectrum,
                             echo_spectrum, R2, R2_unbounded,
                             comfort_noise_spectrum, narrow_peak_band,
                             saturated_echo, render_block, clock_drift: bool):
    """SuppressionGain::GetGain (suppression_gain.cc:452-500). Spectra
    (B, C, 65); narrow_peak_band, saturated_echo (B,); render_block (B,
    bands, 64, C_ren). Returns (state, low-band gain (B, 65), high-bands
    gain (B,))."""
    sup = config.suppressor
    dev = R2.device
    nearend_params = _gain_parameters(sup.last_lf_band, sup.first_hf_band,
                                      sup.nearend_tuning, dev)
    normal_params = _gain_parameters(sup.last_lf_band, sup.first_hf_band,
                                     sup.normal_tuning, dev)

    # Dominant nearend detection (dominant_nearend_detector.cc:30-76).
    dnd = sup.dominant_nearend_detection
    echo_for_dn = R2_unbounded if dnd.use_unbounded_echo_spectrum else R2
    ne_sum = torch.sum(nearend_spectrum[..., 1:16], dim=-1)  # (B, C)
    echo_sum = torch.sum(echo_for_dn[..., 1:16], dim=-1)
    noise_sum = torch.sum(comfort_noise_spectrum[..., 1:16], dim=-1)
    phase_ok = (~state.initial_state | dnd.use_during_initial_phase)
    strong_ne = (phase_ok[:, None] & (echo_sum < dnd.enr_threshold * ne_sum)
                 & (ne_sum > dnd.snr_threshold * noise_sum))
    trig = torch.where(
        strong_ne,
        torch.clamp(state.dn_trigger_counters + 1, max=dnd.trigger_threshold),
        torch.clamp(state.dn_trigger_counters - 1, min=0))
    entered = strong_ne & (trig >= dnd.trigger_threshold)
    hold = torch.where(entered, dnd.hold_duration, state.dn_hold_counters)
    exit_early = (echo_sum > dnd.enr_exit_threshold * ne_sum) & (
        echo_sum > dnd.snr_threshold * noise_sum)
    hold = torch.where(exit_early, 0, hold)
    hold = torch.clamp(hold - 1, min=0)
    nearend_state = torch.any(hold > 0, dim=1)  # (B,)

    # Low-noise render detection (suppression_gain.cc:415-425).
    x0 = render_block[:, 0]  # (B, 64, C_ren)
    x2 = x0 * x0
    x2_sum = torch.sum(x2, dim=(1, 2)) / render_block.shape[3]
    x2_max = torch.amax(x2, dim=(1, 2))
    low_noise = (state.average_power < 50.0 * 50.0 * 64.0) & (
        x2_max < 3.0 * state.average_power)
    avg_power = state.average_power * 0.9 + x2_sum * 0.1

    def sel(nearend_val, normal_val):
        if torch.is_tensor(nearend_val):
            return torch.where(nearend_state[:, None], nearend_val,
                               normal_val)
        return torch.where(nearend_state, nearend_val,
                           normal_val).to(torch.float32)

    # Nearend moving average (moving_average.cc).
    mem = state.nearend_memory.shape[2]
    nearend_avg = (nearend_spectrum + torch.sum(state.nearend_memory, dim=2)
                   ) * (1.0 / (mem + 1))
    if mem > 0:
        slot = (torch.arange(mem, device=dev)[None, :]
                == state.nearend_mem_index[:, None])  # (B, mem)
        new_memory = torch.where(slot[:, None, :, None],
                                 nearend_spectrum[:, :, None, :],
                                 state.nearend_memory)
        mem_index = torch.remainder(state.nearend_mem_index + 1, mem)
    else:
        new_memory = state.nearend_memory
        mem_index = state.nearend_mem_index

    weighted_echo = _weight_echo_for_audibility(config, R2)

    # GetMaxGain.
    inc = sel(nearend_params["max_inc_factor"],
              normal_params["max_inc_factor"])
    max_gain = torch.clamp(
        torch.clamp(state.last_gain * inc[:, None],
                    min=sup.floor_first_increase), max=1.0)

    # GetMinGain per channel.
    min_echo_power = torch.where(
        low_noise, config.echo_audibility.low_render_limit,
        config.echo_audibility.normal_render_limit).to(torch.float32)
    min_gain = torch.where(
        weighted_echo > 0.0,
        torch.clamp(min_echo_power[:, None, None]
                    / torch.clamp(weighted_echo, min=1e-30), max=1.0),
        1.0)
    dec = sel(nearend_params["max_dec_factor_lf"],
              normal_params["max_dec_factor_lf"])
    k = torch.arange(NUM_BINS, device=dev)
    lf_smooth_on = (~state.initial_state
                    | sup.lf_smoothing_during_initial_phase)
    lf_band = k <= sup.last_lf_smoothing_band
    cond = (state.last_nearend > state.last_echo) | (
        k <= sup.last_permanent_lf_smoothing_band)
    smooth = lf_smooth_on[:, None, None] & lf_band & cond
    min_gain = torch.where(
        smooth,
        torch.clamp(torch.maximum(
            min_gain, state.last_gain[:, None, :] * dec[:, None, None]),
            max=1.0),
        min_gain)
    min_gain = torch.where(saturated_echo[:, None, None], 0.0, min_gain)

    # GainToNoAudibleEcho per channel.
    enr = weighted_echo / (nearend_avg + 1.0)
    emr = weighted_echo / (comfort_noise_spectrum[:, :1] + 1.0)
    enr_t = sel(nearend_params["enr_transparent"],
                normal_params["enr_transparent"])[:, None]
    enr_s = sel(nearend_params["enr_suppress"],
                normal_params["enr_suppress"])[:, None]
    emr_t = sel(nearend_params["emr_transparent"],
                normal_params["emr_transparent"])[:, None]
    g = torch.where(
        (enr > enr_t) & (emr > emr_t),
        torch.maximum((enr_s - enr) / torch.clamp(enr_s - enr_t, min=1e-10),
                      emr_t / torch.clamp(emr, min=1e-30)),
        1.0)
    g = torch.minimum(torch.maximum(g, min_gain), max_gain[:, None, :])
    gain = torch.min(g, dim=1)[0]  # min across channels

    # LimitLowFrequencyGains (suppression_gain.cc:28-32).
    g01 = torch.minimum(gain[:, 1:2], gain[:, 2:3])
    gain = torch.cat([g01, g01, gain[:, 2:]], dim=1)

    # LimitHighFrequencyGains (:34-71).
    lim_band = sup.high_frequency_suppression.limiting_gain_band
    n_lim = sup.high_frequency_suppression.bands_in_limiting_gain
    limited = gain
    if n_lim > 0:
        min_upper = torch.clamp(
            torch.amin(gain[:, lim_band:lim_band + n_lim], dim=1), max=1.0)
        limited = torch.where(k > lim_band,
                              torch.minimum(gain, min_upper[:, None]), gain)
    limited = torch.cat([limited[:, :64], limited[:, 63:64]], dim=1)
    apply_hf_limit = (~nearend_state | clock_drift
                      | sup.conservative_hf_suppression)
    gain = torch.where(apply_hf_limit[:, None], limited, gain)

    new_state = state.replace(
        last_gain=gain,
        last_nearend=nearend_avg,
        last_echo=weighted_echo,
        nearend_memory=new_memory,
        nearend_mem_index=mem_index.to(_I32),
        average_power=avg_power,
        dn_trigger_counters=trig.to(_I32),
        dn_hold_counters=hold.to(_I32),
        dn_nearend_state=nearend_state,
    )
    amp_gain = torch.sqrt(torch.clamp(gain, min=0.0))

    # UpperBandsGain (suppression_gain.cc:112-190).
    if render_block.shape[1] == 1:
        high_gain = torch.ones_like(avg_power)
    else:
        hbs = sup.high_bands_suppression
        narrow = (narrow_peak_band >= 0) & (narrow_peak_band > NUM_BINS - 10)
        gain_below_8 = torch.amin(amp_gain[:, 32:], dim=1)
        low_energy = torch.amax(torch.sum(render_block[:, 0] ** 2, dim=1),
                                dim=1)
        high_energy = torch.amax(torch.sum(render_block[:, 1:] ** 2, dim=2),
                                 dim=(1, 2))
        act_thr = BLOCK_SIZE * hbs.anti_howling_activation_threshold
        anti_howl = torch.where(
            high_energy < torch.clamp(low_energy, min=act_thr), 1.0,
            hbs.anti_howling_gain * torch.sqrt(
                low_energy / torch.clamp(high_energy, min=1e-10)))
        echo_lf = torch.sum(echo_spectrum[..., 1:16], dim=-1)
        noise_lf = torch.sum(comfort_noise_spectrum[..., 1:16], dim=-1)
        bound = torch.where(
            ~nearend_state & torch.any(echo_lf > hbs.enr_threshold * noise_lf,
                                       dim=1),
            hbs.max_gain_during_echo, 1.0)
        high_gain = torch.minimum(torch.minimum(gain_below_8, anti_howl),
                                  bound)
        high_gain = torch.where(saturated_echo,
                                torch.clamp(gain_below_8, max=0.001),
                                high_gain)
        high_gain = torch.where(narrow, 0.001, high_gain)
    return new_state, amp_gain, high_gain


def set_initial_state(config, state: SuppressionGainState, value: bool):
    """SuppressionGain::SetInitialState (suppression_gain.cc:502-509)."""
    return state.replace(
        initial_state=torch.full_like(state.initial_state, value),
        initial_state_change_counter=torch.full_like(
            state.initial_state_change_counter,
            config.filter.config_change_duration_blocks if value else 0),
    )


# ------------------------------------------------------ suppression filter


@dataclass
class SuppressionFilterState:
    e_output_old: torch.Tensor  # (B, bands, C, 64)


def init_suppression_filter(num_bands, num_capture, batch, device):
    return SuppressionFilterState(e_output_old=torch.zeros(
        (batch, num_bands, num_capture, BLOCK_SIZE), dtype=torch.float32,
        device=device))


def suppression_filter_apply(state: SuppressionFilterState, comfort_noise,
                             comfort_noise_high, gain, high_bands_gain,
                             E_lowest, e_block):
    """SuppressionFilter::ApplyGain (suppression_filter.cc:77-180).
    comfort noise and E_lowest (B, C, 65) complex, gain (B, 65),
    high_bands_gain (B,), e_block (B, bands, 64, C). Returns (state, out
    (B, bands, 64, C))."""
    num_bands = e_block.shape[1]
    noise_gain = torch.sqrt(torch.clamp(1.0 - gain * gain, min=0.0))
    hb_noise_scale = 0.4 * torch.sqrt(
        torch.clamp(1.0 - high_bands_gain * high_bands_gain, min=0.0))

    E = E_lowest * gain[:, None, :] + noise_gain[:, None, :] * comfort_noise
    e_ext = afft.ifft_unnormalized(E)  # (B, C, 128)
    k_norm = 2.0 / 128.0
    win = afft.window("sqrt_hanning", E.device)
    e0 = (state.e_output_old[:, 0] * win[64:]
          + e_ext[..., :64] * win[:64]) * k_norm
    out_bands = [e0.transpose(1, 2)]
    new_old = [e_ext[..., 64:]]
    for b in range(1, num_bands):
        eb = e_block[:, b].transpose(1, 2) * high_bands_gain[:, None, None]
        if b == 1:
            hb_noise = afft.ifft_unnormalized(comfort_noise_high)[..., :64]
            eb = eb + hb_noise * (hb_noise_scale * k_norm)[:, None, None]
        # The upper bands are delayed one block.
        out_bands.append(state.e_output_old[:, b].transpose(1, 2))
        new_old.append(eb)
    out = torch.clamp(torch.stack(out_bands, dim=1), -32768.0, 32767.0)
    return (SuppressionFilterState(e_output_old=torch.stack(new_old, dim=1)),
            out)


# ----------------------------------------------------------- echo remover


@dataclass
class EchoRemoverState:
    subtractor: subt.SubtractorState
    analyzer: subt.RenderSignalAnalyzerState
    aec: aecs.AecStateState
    cng: ComfortNoiseState
    residual: ResidualEchoState
    supp_gain: SuppressionGainState
    supp_filter: SuppressionFilterState
    e_old: torch.Tensor  # (B, C, 64)
    y_old: torch.Tensor  # (B, C, 64)
    gain_change_hangover: torch.Tensor  # (B,) int32
    refined_last_selected: torch.Tensor  # (B, C) bool


def init_state(config: EchoCanceller3Config, num_bands, num_render,
               num_capture, batch, device) -> EchoRemoverState:
    sub_state = subt.init_state(config, num_render, num_capture, batch,
                                device)
    p_max = sub_state.refined.H.shape[2]
    return EchoRemoverState(
        subtractor=sub_state,
        analyzer=subt.init_analyzer(batch, device),
        aec=aecs.init_state(config, num_capture, p_max, batch, device),
        cng=init_comfort_noise(num_capture, batch, device),
        residual=init_residual_echo(config, batch, device),
        supp_gain=init_suppression_gain(config, num_capture, batch, device),
        supp_filter=init_suppression_filter(num_bands, num_capture, batch,
                                            device),
        e_old=torch.zeros((batch, num_capture, BLOCK_SIZE),
                          dtype=torch.float32, device=device),
        y_old=torch.zeros((batch, num_capture, BLOCK_SIZE),
                          dtype=torch.float32, device=device),
        gain_change_hangover=torch.zeros((batch,), dtype=_I32,
                                         device=device),
        refined_last_selected=torch.ones((batch, num_capture),
                                         dtype=torch.bool, device=device),
    )


@functools.lru_cache(maxsize=None)
def _transition(device):
    return torch.cat([torch.arange(1, 31) / 31.0, torch.ones(34)]).to(
        torch.float32).to(device)


def _form_linear_filter_output(config, last_refined, out):
    """FormLinearFilterOutput (echo_remover.cc:452-489), per channel.
    Returns (e (B, C, 64), use_refined (B, C))."""
    e_ref, e_coa = out["e_refined"], out["e_coarse"]
    if config.filter.enable_coarse_filter_output_usage:
        prefer_coarse = (
            (out["e2_coarse"] < 0.9 * out["e2_refined"])
            & (out["y2"] > 30.0 * 30.0 * BLOCK_SIZE)
            & ((out["s2_refined"] > 60.0 * 60.0 * BLOCK_SIZE)
               | (out["s2_coarse"] > 60.0 * 60.0 * BLOCK_SIZE)))
        diverged = (out["e2_coarse"] < out["e2_refined"]) & (
            out["y2"] < out["e2_refined"])
        use_refined = ~(prefer_coarse | (~prefer_coarse & diverged))
    else:
        use_refined = torch.ones_like(last_refined)
    from_sig = torch.where(last_refined[..., None], e_ref, e_coa)
    to_sig = torch.where(use_refined[..., None], e_ref, e_coa)
    t = _transition(e_ref.device)
    blended = t * to_sig + (1.0 - t) * from_sig
    e = torch.where((last_refined == use_refined)[..., None], to_sig, blended)
    return e, use_refined


def process_capture(*args, **kwargs):
    """EchoRemoverImpl::ProcessCapture for one block: the per-block path."""
    raise NotImplementedError(
        "the per-block echo remover (echo_remover.process_capture) is not "
        "ported yet (ROADMAP Queue 1 item 11); the main path runs "
        "process_capture_pair")


def process_capture_pair(config: EchoCanceller3Config,
                         state: EchoRemoverState, geo: rb.BufferGeometry,
                         views, capture_blocks, delay_changes, gain_change,
                         capture_signal_saturation, external_delays,
                         external_delay_valids, pair_kernel: bool = False):
    """EchoRemoverImpl::ProcessCapture (echo_remover.cc:236-450) for all
    capture blocks of one frame, in the JAX twin's three phases:

    A) the render windows of the frame as two chains per ring (four K2
       reads per frame), the render-signal analyzer and the gain-change
       hangover;
    B) the subtractor over all blocks: ``subtractor.process_pair`` on the
       per-block FFT windows, or, with ``pair_kernel``, the pair kernel K6
       on the sf chain and the blocks' offsets into it
       (``subtractor_kernel.process_pair_kernel``). The geometry allows
       ``pair_kernel`` only where the coarse filter is no longer than the
       refined one (``subtractor_kernel.supported``);
    C) per block: AEC state, comfort noise, residual echo, suppression.

    views: one rb.RenderView per block; capture_blocks (B, bands, 64, C)
    each; delay_changes, external_delays, external_delay_valids (B,) each;
    gain_change and capture_signal_saturation (B,). The analyzer's delay
    and the initial-state transition use the frame-entry values (the JAX
    twin's accepted staleness of up to 2 blocks).

    Returns (state, [out block (B, bands, 64, C)], [linear e (B, C, 64)])."""
    nb = len(views)
    L = geo.num_blocks
    y0s = [cb[:, 0].transpose(1, 2) for cb in capture_blocks]  # (B, C, 64)

    p_ref_max = max(state.subtractor.refined.H.shape[2],
                    state.subtractor.coarse.H.shape[2])
    headroom_blocks = int(config.delay.delay_headroom_samples) // 64
    delay_bound = max(config.filter.refined.length_blocks, headroom_blocks + 1)
    spec_win_len = min(
        max(p_ref_max, delay_bound + 2)
        + max(config.echo_model.render_post_window_size, 1) + 1, L)
    W_b = min(delay_bound, L)

    # Phase A1: each block's windows are contiguous spans whose starts move
    # by -1 (sf) or +1 (blocks) per block except across one delay jump, so
    # two chains per ring (the block-0 trajectory and the last block's
    # anchor) cover every block.
    W_chain = spec_win_len + nb - 1
    W_bchain = W_b + nb - 1
    last = views[-1]
    sf_starts = [rb.s_read_index(geo, v.state, v.n) for v in views]
    sf_a = torch.remainder(sf_starts[0] - (nb - 1), L)
    sf_b = sf_starts[-1]
    sf_chain = torch.cat([rb.sf_span(geo, last, sf_a, W_chain),
                          rb.sf_span(geo, last, sf_b, W_chain)], dim=1)
    b_starts = [torch.remainder(rb.b_read_index(geo, v.state, v.n)
                                - (W_b - 1), L) for v in views]
    b_a = b_starts[0]
    b_b = torch.remainder(b_starts[-1] - (nb - 1), L)
    b_chain = torch.cat([rb.blocks_span(geo, last, b_a, W_bchain),
                         rb.blocks_span(geo, last, b_b, W_bchain)], dim=1)

    def chain_offset(start, anchor_a, anchor_b, width):
        # Prefer chain B (the post-jump anchor); a start in neither chain
        # clamps into chain A.
        off_a = torch.remainder(start - anchor_a, L)
        off_b = torch.remainder(start - anchor_b, L)
        return torch.where(off_b <= nb - 1, width + off_b,
                           torch.clamp(off_a, 0, nb - 1))

    sf_offs, spec_wins, X_windows, blocks_wins = [], [], [], []
    for k in range(nb):
        sf_offs.append(chain_offset(sf_starts[k], sf_a, sf_b, W_chain))
        rows = rb.window_slice(sf_chain, sf_offs[k], spec_win_len)
        spec_wins.append(rb.sf_spectrum(geo, rows))
        if not pair_kernel:
            X_windows.append(rb.sf_fft(geo, rows[:, :p_ref_max]))
        brows = rb.window_slice(
            b_chain, chain_offset(b_starts[k], b_a, b_b, W_bchain), W_b)
        blocks_wins.append(rb.blocks_rows(geo, torch.flip(brows, dims=[1])))

    # Phase A2: gain-change hangover, analyzer evolution.
    gain_changes, hangover = [], state.gain_change_hangover
    for _ in range(nb):
        gc = gain_change & (hangover == 0)
        hangover = torch.where(gc, 3, torch.clamp(hangover - 1, min=0))
        gain_changes.append(gc)
    analyzer = state.analyzer
    analyzer_states = []
    for k in range(nb):
        analyzer = subt.analyzer_update(config, analyzer, spec_wins[k],
                                        blocks_wins[k][:, 0],
                                        state.aec.min_filter_delay)
        analyzer_states.append(analyzer)

    # Phase B: the subtractor over all blocks.
    transition0 = state.aec.transition_triggered
    transitions = [transition0] + [torch.zeros_like(transition0)] * (nb - 1)
    masks = [subt.narrow_zero_mask(a) for a in analyzer_states]
    poors = [subt.poor_signal_excitation(a) for a in analyzer_states]
    if pair_kernel:
        sub_state, sub_outs = subtractor_kernel.process_pair_kernel(
            config, geo, state.subtractor, sf_chain, sf_offs, y0s, masks,
            poors, delay_changes, transitions, capture_signal_saturation)
    else:
        sub_state, sub_outs = subt.process_pair(
            config, state.subtractor, X_windows,
            [w[:, :p_ref_max] for w in spec_wins], y0s, masks, poors,
            delay_changes, transitions, capture_signal_saturation)

    # Phase C: per-block AEC state, comfort noise, residual, suppression.
    aec = state.aec.replace(
        capture_signal_saturation=capture_signal_saturation)
    cng_state = state.cng
    residual_state = state.residual
    supp_gain_state = state.supp_gain
    supp_filter_state = state.supp_filter
    e_old, y_old = state.e_old, state.y_old
    use_refined = state.refined_last_selected
    outs, linears = [], []
    for k in range(nb):
        y0 = y0s[k]
        sub_out = sub_outs[k]
        aec = aecs.handle_echo_path_change(config, aec, delay_changes[k],
                                           gain_changes[k])
        supp_gain_state = tree_where(
            delay_changes[k], set_initial_state(config, supp_gain_state, True),
            supp_gain_state)
        transition = aec.transition_triggered if k > 0 else transition0
        supp_gain_state = tree_where(
            transition, set_initial_state(config, supp_gain_state, False),
            supp_gain_state)

        e, use_refined = _form_linear_filter_output(config, use_refined,
                                                    sub_out)
        YE = afft.padded_fft(torch.stack([y0, e], dim=1),
                             torch.stack([y_old, e_old], dim=1),
                             "sqrt_hanning")
        Y, E = YE[:, 0], YE[:, 1]
        S2_linear = afft.spectrum(Y - E)
        Y2 = afft.spectrum(Y)
        E2 = afft.spectrum(E)

        aec = aecs.update(
            config, aec, geo, views[k], external_delays[k],
            external_delay_valids[k],
            sub_out["refined_frequency_responses"],
            sub_out["refined_impulse_responses"],
            sub_out["refined_current_size"], E2, Y2, sub_out,
            spec_win=spec_wins[k], blocks_win=blocks_wins[k])

        usable = aec.usable_linear_estimate[:, None, None]
        nearend_spectrum = torch.where(usable, E2, Y2)
        Y_fft = torch.where(usable, E, Y)
        cng_state, N_low, N_high, N2 = comfort_noise_compute(
            config, cng_state, aec.capture_signal_saturation,
            nearend_spectrum)
        transparent = aecs.transparent_mode_active(config, aec)
        residual_state, R2, R2_unbounded = residual_echo_estimate(
            config, residual_state, aec, S2_linear, Y2,
            supp_gain_state.dn_nearend_state, transparent,
            sub_out["refined_current_size"], spec_wins[k])

        nearend_for_gain = torch.where(usable, torch.minimum(E2, Y2), Y2)
        echo_spectrum = torch.where(usable, S2_linear, R2)
        supp_gain_state, G, high_gain = suppression_gain_compute(
            config, supp_gain_state, nearend_for_gain, echo_spectrum, R2,
            R2_unbounded, N2, analyzer_states[k].narrow_peak_band,
            aec.saturated_echo, blocks_wins[k][:, 0],
            config.echo_removal_control.has_clock_drift)
        supp_filter_state, out = suppression_filter_apply(
            supp_filter_state, N_low, N_high, G, high_gain, Y_fft,
            capture_blocks[k])
        e_old, y_old = e, y0
        outs.append(out)
        linears.append(e)

    new_state = EchoRemoverState(
        subtractor=sub_state,
        analyzer=analyzer,
        aec=aec,
        cng=cng_state,
        residual=residual_state,
        supp_gain=supp_gain_state,
        supp_filter=supp_filter_state,
        e_old=e_old,
        y_old=y_old,
        gain_change_hangover=hangover.to(_I32),
        refined_last_selected=use_refined,
    )
    return new_state, outs, linears
