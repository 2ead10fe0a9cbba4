"""Legacy fixed-point GMM VAD (WebRtcVad), the int16/int32 Q-math twin.

Port of ``webrtc_audio_processing_tpu/models/vad/legacy_vad.py``
(reference: common_audio/vad/{webrtc_vad.c, vad_core.c, vad_filterbank.c,
vad_gmm.c, vad_sp.c} and signal_processing/energy.c), bit for bit. The
per-sample all-pass, high-pass and downsampling recurrences run as Python
loops over the frame's samples on (N,) rows; the Gaussian model, its
updates and the 16-minimum tracking are vectorized over N x 2 Gaussians x
6 sub-bands. Every int16 store is wrapped as in the reference.

``LegacyVad(sample_rate_hz, mode)`` is the component; its ``forward(state,
audio) -> (state, vad)`` takes (N, L) int16-valued int32 frames.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from webrtc_audio_processing_tpu_torch.ops import spl
from webrtc_audio_processing_tpu_torch.ops.batch import const

I32 = torch.int32

NUM_CHANNELS = 6
NUM_GAUSSIANS = 2
MIN_ENERGY = 10

SPECTRUM_WEIGHT = (6, 8, 10, 12, 14, 16)
NOISE_UPDATE_CONST = 655  # Q15
SPEECH_UPDATE_CONST = 6554  # Q15
BACK_ETA = 154  # Q8
MINIMUM_DIFFERENCE = (544, 544, 576, 576, 576, 576)
MAXIMUM_SPEECH = (11392, 11392, 11520, 11520, 11520, 11520)
MINIMUM_MEAN = (640, 768)
MAXIMUM_NOISE = (9216, 9088, 8960, 8832, 8704, 8576)

# (gaussian, channel) layout, the reference's ``channel + k * kNumChannels``.
NOISE_DATA_WEIGHTS = ((34, 62, 72, 66, 53, 25), (94, 66, 56, 62, 75, 103))
SPEECH_DATA_WEIGHTS = ((48, 82, 45, 87, 50, 47), (80, 46, 83, 41, 78, 81))
NOISE_DATA_MEANS = ((6738, 4892, 7065, 6715, 6771, 3369),
                    (7646, 3863, 7820, 7266, 5020, 4362))
SPEECH_DATA_MEANS = ((8306, 10085, 10078, 11823, 11843, 6309),
                     (9473, 9571, 10879, 7581, 8180, 7483))
NOISE_DATA_STDS = ((378, 1064, 493, 582, 688, 593),
                   (474, 697, 475, 688, 421, 455))
SPEECH_DATA_STDS = ((555, 505, 567, 524, 585, 1231),
                    (509, 828, 492, 1540, 1079, 850))

MAX_SPEECH_FRAMES = 6
MIN_STD = 384

# Aggressiveness thresholds per mode and frame length (10/20/30 ms),
# vad_core.c:70-92: (overhang 1, overhang 2, individual, total).
MODE_TABLES = {
    0: ((8, 4, 3), (14, 7, 5), (24, 21, 24), (57, 48, 57)),
    1: ((8, 4, 3), (14, 7, 5), (37, 32, 37), (100, 80, 100)),
    2: ((6, 3, 2), (9, 5, 3), (82, 78, 82), (285, 260, 285)),
    3: ((6, 3, 2), (9, 5, 3), (94, 94, 94), (1100, 1050, 1100)),
}

# Filterbank constants (vad_filterbank.c:16-29).
HP_ZERO_COEFS = (6631, -13262, 6631)
HP_POLE_COEFS = (16384, -7756, 5620)
ALLPASS_Q15 = (20972, 5571)
OFFSET_VECTOR = (368, 368, 272, 176, 176, 176)
LOG_CONST = 24660
LOG_ENERGY_INT_PART = 14336

# vad_sp.c downsampling and minimum-tracking constants.
ALLPASS_Q13 = (5243, 1392)
SMOOTHING_DOWN = 6553
SMOOTHING_UP = 32439

COMP_VAR = 22005
LOG2_EXP = 5909  # Q12

_s16 = spl.wrap_i16


@dataclass
class VadState:
    """VadInstT (vad_core.h:24-56); leaves (N, ...)."""

    noise_means: torch.Tensor  # (N, 2, 6) int32 Q7
    speech_means: torch.Tensor
    noise_stds: torch.Tensor
    speech_stds: torch.Tensor
    frame_counter: torch.Tensor  # (N,) int32
    over_hang: torch.Tensor
    num_of_speech: torch.Tensor
    low_value_vector: torch.Tensor  # (N, 6, 16) int32
    index_vector: torch.Tensor  # (N, 6, 16) int32 ages
    mean_value: torch.Tensor  # (N, 6) int32
    upper_state: torch.Tensor  # (N, 5) int32 split filter states
    lower_state: torch.Tensor  # (N, 5) int32
    hp_filter_state: torch.Tensor  # (N, 4) int32
    downsampling_filter_states: torch.Tensor  # (N, 4) int32

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def init_state(batch: int, device) -> VadState:
    def tab(v):
        t = torch.tensor(v, dtype=I32, device=device)
        return t.expand((batch,) + t.shape).clone()

    def full(shape, v):
        return torch.full((batch,) + shape, v, dtype=I32, device=device)

    return VadState(
        noise_means=tab(NOISE_DATA_MEANS),
        speech_means=tab(SPEECH_DATA_MEANS),
        noise_stds=tab(NOISE_DATA_STDS),
        speech_stds=tab(SPEECH_DATA_STDS),
        frame_counter=full((), 0),
        over_hang=full((), 0),
        num_of_speech=full((), 0),
        low_value_vector=full((6, 16), 10000),
        index_vector=full((6, 16), 0),
        mean_value=full((6,), 1600),
        upper_state=full((5,), 0),
        lower_state=full((5,), 0),
        hp_filter_state=full((4,), 0),
        downsampling_filter_states=full((4,), 0),
    )


# ------------------------------------------------------------- filterbank


def _all_pass_filter(data, coefficient: int, filter_state):
    """AllPassFilter (vad_filterbank.c:84-109). data: (N, L) every other
    sample; filter_state: (N,). Returns (y (N, L), new state (N,))."""
    state32 = filter_state * 65536
    ys = []
    for n in range(data.shape[1]):
        x = data[:, n]
        y = _s16((state32 + coefficient * x) >> 16)
        state32 = (x * 16384 - coefficient * y) * 2
        ys.append(y)
    return torch.stack(ys, 1), _s16(state32 >> 16)


def _split_filter(data, upper_state, lower_state):
    """SplitFilter (vad_filterbank.c:112-143)."""
    hp, new_up = _all_pass_filter(data[:, 0::2], ALLPASS_Q15[0], upper_state)
    lp, new_low = _all_pass_filter(data[:, 1::2], ALLPASS_Q15[1], lower_state)
    return _s16(hp - lp), _s16(hp + lp), new_up, new_low


def _high_pass_filter(data, filter_state):
    """HighPassFilter (vad_filterbank.c:39-72)."""
    s0, s1, s2, s3 = filter_state.unbind(-1)
    ys = []
    for n in range(data.shape[1]):
        x = data[:, n]
        tmp32 = (HP_ZERO_COEFS[0] * x + HP_ZERO_COEFS[1] * s0
                 + HP_ZERO_COEFS[2] * s1)
        tmp32 = tmp32 - HP_POLE_COEFS[1] * s2 - HP_POLE_COEFS[2] * s3
        y = _s16(tmp32 >> 14)
        s0, s1, s2, s3 = x, s0, y, s2
        ys.append(y)
    return torch.stack(ys, 1), torch.stack([s0, s1, s2, s3], -1)


def _energy(x, length: int):
    """WebRtcSpl_Energy with GetScalingSquare (energy.c,
    get_scaling_square.c) over each row of x (N, L)."""
    nbits = int(np.floor(np.log2(length))) + 1  # GetSizeInBits(length)
    smax = torch.amax(torch.abs(x), dim=1)
    t = spl.norm_w32(smax * smax)
    scaling = torch.where(smax == 0, 0,
                          torch.where(t > nbits, 0, nbits - t)).to(I32)
    en = torch.sum((x * x) >> scaling[:, None], dim=1, dtype=I32)
    return en, scaling


def _log_of_energy(x, length: int, offset: int, total_energy):
    """LogOfEnergy (vad_filterbank.c:146-233)."""
    energy_i32, tot_rshifts = _energy(x, length)
    energy = energy_i32.to(torch.int64) & 0xFFFFFFFF  # the uint32 view

    zero = energy_i32 == 0
    norm_shifts = 17 - spl.norm_u32(energy_i32)
    tot = tot_rshifts + norm_shifts
    left = torch.clamp(-norm_shifts, 0, 31).to(torch.int64)
    right = torch.clamp(norm_shifts, 0, 31).to(torch.int64)
    e_norm = spl._from_u32(torch.where(norm_shifts < 0, energy << left,
                                       energy >> right))

    log2_energy = LOG_ENERGY_INT_PART + ((e_norm & 0x3FFF) >> 4)
    log_e = ((LOG_CONST * log2_energy) >> 19) + ((tot * LOG_CONST) >> 9)
    log_e = torch.clamp(log_e, min=0) + offset
    log_e = torch.where(zero, offset, log_e)

    # total_energy update while it is <= kMinEnergy, on the post-normalizing
    # shift count (vad_filterbank.c:184, 236-247).
    add = torch.where(tot >= 0, MIN_ENERGY + 1,
                      e_norm >> torch.clamp(-tot, 0, 31))
    total_energy = torch.where((total_energy <= MIN_ENERGY) & ~zero,
                               _s16(total_energy + add), total_energy)
    return log_e.to(I32), total_energy.to(I32)


def calculate_features(state: VadState, data, length: int):
    """WebRtcVad_CalculateFeatures (vad_filterbank.c:236-339).

    data: (N, length) int32 8 kHz samples (80/160/240). Returns (state,
    features (N, 6), total_energy (N,))."""
    total_energy = torch.zeros(data.shape[0], dtype=I32, device=data.device)
    up = state.upper_state.unbind(-1)
    low = state.lower_state.unbind(-1)

    hp120, lp120, u0, l0 = _split_filter(data, up[0], low[0])  # 2000 Hz
    hp60, lp60, u1, l1 = _split_filter(hp120, up[1], low[1])  # 3000 Hz
    n4 = length // 4
    f5, total_energy = _log_of_energy(hp60, n4, OFFSET_VECTOR[5],
                                      total_energy)
    f4, total_energy = _log_of_energy(lp60, n4, OFFSET_VECTOR[4],
                                      total_energy)

    hp60b, lp60b, u2, l2 = _split_filter(lp120, up[2], low[2])  # 1000 Hz
    f3, total_energy = _log_of_energy(hp60b, n4, OFFSET_VECTOR[3],
                                      total_energy)

    hp120b, lp120b, u3, l3 = _split_filter(lp60b, up[3], low[3])  # 500 Hz
    n8 = length // 8
    f2, total_energy = _log_of_energy(hp120b, n8, OFFSET_VECTOR[2],
                                      total_energy)

    hp60c, lp60c, u4, l4 = _split_filter(lp120b, up[4], low[4])  # 250 Hz
    n16 = length // 16
    f1, total_energy = _log_of_energy(hp60c, n16, OFFSET_VECTOR[1],
                                      total_energy)

    hp_out, hp_state = _high_pass_filter(lp60c, state.hp_filter_state)
    f0, total_energy = _log_of_energy(hp_out, n16, OFFSET_VECTOR[0],
                                      total_energy)

    state = state.replace(
        upper_state=torch.stack([u0, u1, u2, u3, u4], -1),
        lower_state=torch.stack([l0, l1, l2, l3, l4], -1),
        hp_filter_state=hp_state,
    )
    features = torch.stack([f0, f1, f2, f3, f4, f5], -1)
    return state, features, total_energy


# --------------------------------------------------------------- vad_sp


def downsample_by_2(data, filter_state):
    """WebRtcVad_Downsampling (vad_sp.c:26-52). data: (N, L) int32;
    filter_state: (N, 2). Returns ((N, L // 2), new state)."""
    s1, s2 = filter_state.unbind(-1)
    ys = []
    for k in range(data.shape[1] // 2):
        x0, x1 = data[:, 2 * k], data[:, 2 * k + 1]
        t1 = _s16((s1 >> 1) + ((ALLPASS_Q13[0] * x0) >> 14))
        s1 = x0 - ((ALLPASS_Q13[0] * t1) >> 12)
        t2 = _s16((s2 >> 1) + ((ALLPASS_Q13[1] * x1) >> 14))
        s2 = x1 - ((ALLPASS_Q13[1] * t2) >> 12)
        ys.append(_s16(t1 + t2))
    return torch.stack(ys, 1), torch.stack([s1, s2], -1)


def _pad(cond, ref):
    """(N,) -> (N, 1, ...) to broadcast against ``ref``."""
    return cond.reshape(cond.shape + (1,) * (ref.dim() - cond.dim()))


def find_minimum(state: VadState, features, power_ok):
    """WebRtcVad_FindMinimum (vad_sp.c:56-181), vectorized over N x 6.

    Returns (state, smoothed minimum (N, 6))."""
    dev = features.device
    sv = state.low_value_vector  # (N, 6, 16)
    age = state.index_vector

    # Aging and expiry: the literal 16-step C loop (vad_sp.c:76-90),
    # unrolled; an expiry shifts the suffix down, so the entry shifted into
    # the slot skips this call's aging tick.
    idx = torch.arange(16, device=dev)
    sv2, age2 = sv, age
    for i in range(16):
        expire = age2[..., i:i + 1] == 100
        sv_roll = torch.roll(sv2, -1, dims=-1)
        age_roll = torch.roll(age2, -1, dims=-1)
        shifted_sv = torch.where(idx >= i, torch.where(idx == 15, 10000,
                                                       sv_roll), sv2)
        shifted_age = torch.where(idx >= i, torch.where(idx == 15, 101,
                                                        age_roll), age2)
        sv2 = torch.where(expire, shifted_sv, sv2)
        age2 = torch.where(expire, shifted_age,
                           torch.where(idx == i, age2 + 1, age2))

    # Insert the feature before the first larger entry.
    f = features[..., None]
    smaller = f < sv2
    pos = torch.argmax(smaller.to(I32), dim=-1, keepdim=True)
    do_insert = smaller.any(-1, keepdim=True)
    src_up = torch.where(idx > pos, idx - 1, idx)
    sv3 = torch.gather(sv2, -1, src_up)
    age3 = torch.gather(age2, -1, src_up)
    sv3 = torch.where(idx == pos, f, sv3)
    age3 = torch.where(idx == pos, 1, age3)
    sv3 = torch.where(do_insert, sv3, sv2).to(I32)
    age3 = torch.where(do_insert, age3, age2).to(I32)

    fc = state.frame_counter[:, None]
    median = torch.where(fc > 2, sv3[..., 2],
                         torch.where(fc > 0, sv3[..., 0], 1600))
    alpha = torch.where(
        fc > 0,
        torch.where(median < state.mean_value, SMOOTHING_DOWN, SMOOTHING_UP),
        0)
    tmp32 = ((alpha + 1) * state.mean_value + (32767 - alpha) * median
             + 16384)
    mean = _s16(tmp32 >> 15).to(I32)

    state = state.replace(
        low_value_vector=torch.where(_pad(power_ok, sv3), sv3,
                                     state.low_value_vector),
        index_vector=torch.where(_pad(power_ok, age3), age3,
                                 state.index_vector),
        mean_value=torch.where(power_ok[:, None], mean, state.mean_value),
    )
    return state, mean


# ---------------------------------------------------------------- vad_gmm


def gaussian_probability(x, mean, std):
    """WebRtcVad_GaussianProbability (vad_gmm.c:30-85), elementwise.

    Returns (probability Q20, delta Q11)."""
    inv_std = spl.div_w32_w16(131072 + (std >> 1), std)  # Q10
    t = inv_std >> 2
    inv_std2 = (t * t) >> 2  # Q14
    x7 = _s16(x * 8 - mean)  # Q7
    delta = _s16((inv_std2 * x7) >> 10)  # Q11
    expo = (delta * x7) >> 9  # Q10

    t16 = _s16(-((LOG2_EXP * expo) >> 12))
    exp_value = 0x0400 | (t16 & 0x03FF)
    t2 = _s16(t16 ^ 0xFFFF) >> 10
    t2 = t2 + 1
    exp_value = exp_value >> torch.clamp(t2, 0, 31)
    exp_value = torch.where(expo < COMP_VAR, exp_value, 0)
    return inv_std * exp_value, delta


# --------------------------------------------------------------- vad_core


def _weighted_average(data, offset, weights):
    """WeightedAverage (vad_core.c:102-113) over the Gaussian axis (-2)."""
    upd = data + offset
    return upd, torch.sum(upd * weights, dim=-2, dtype=I32)


def gmm_probability(state: VadState, features, total_power,
                    frame_index: int, mode: int):
    """GmmProbability (vad_core.c:127-487). frame_index: 0/1/2 for
    80/160/240-sample frames (static). Returns (state, vadflag (N,))."""
    oh1, oh2, individual, total = (tbl[frame_index]
                                   for tbl in MODE_TABLES[mode])
    dev = features.device
    power_ok = total_power > MIN_ENERGY
    nw = const(NOISE_DATA_WEIGHTS, I32, dev)
    sw = const(SPEECH_DATA_WEIGHTS, I32, dev)
    feat = features[:, None, :]  # (N, 1, 6)

    noise_prob, delta_n = gaussian_probability(feat, state.noise_means,
                                               state.noise_stds)
    speech_prob, delta_s = gaussian_probability(feat, state.speech_means,
                                                state.speech_stds)
    noise_probability = nw * noise_prob  # (N, 2, 6) Q27
    speech_probability = sw * speech_prob
    h0_test = torch.sum(noise_probability, dim=1, dtype=I32)  # (N, 6)
    h1_test = torch.sum(speech_probability, dim=1, dtype=I32)

    shifts_h0 = torch.where(h0_test == 0, 31, spl.norm_w32(h0_test))
    shifts_h1 = torch.where(h1_test == 0, 31, spl.norm_w32(h1_test))
    llr = shifts_h0 - shifts_h1
    sum_llr = torch.sum(llr * const(SPECTRUM_WEIGHT, I32, dev), dim=-1,
                        dtype=I32)
    vadflag = ((llr * 4) > individual).any(-1) | (sum_llr >= total)

    # Conditional Gaussian probabilities (Q14).
    h0 = _s16(h0_test >> 12)
    h1 = _s16(h1_test >> 12)
    ngp0 = torch.where(
        h0 > 0,
        spl.div_w32_w16((noise_probability[:, 0] & -4096) * 4,
                        torch.clamp(h0, min=1)),
        16384)
    ngp1 = torch.where(h0 > 0, 16384 - ngp0, 0)
    ngprvec = torch.stack([ngp0, ngp1], 1)
    sgp0 = torch.where(
        h1 > 0,
        spl.div_w32_w16((speech_probability[:, 0] & -4096) * 4,
                        torch.clamp(h1, min=1)),
        0)
    sgp1 = torch.where(h1 > 0, 16384 - sgp0, 0)
    sgprvec = torch.stack([sgp0, sgp1], 1)

    vadflag = vadflag & power_ok
    vf = vadflag[:, None, None]

    # Model update (applied only when power_ok, at the end).
    state, feature_minimum = find_minimum(state, features, power_ok)

    _, noise_gmean = _weighted_average(state.noise_means, 0, nw)
    tmp1 = _s16(noise_gmean >> 6)  # (N, 6) Q8

    nmk = state.noise_means
    smk = state.speech_means
    nsk = state.noise_stds
    ssk = state.speech_stds

    # Noise mean update (frames without speech).
    delt = _s16((ngprvec * delta_n) >> 11)
    nmk2 = torch.where(vf, nmk,
                       _s16(nmk + ((delt * NOISE_UPDATE_CONST) >> 22)))
    ndelt = _s16(feature_minimum * 16 - tmp1)[:, None, :]
    nmk3 = _s16(nmk2 + ((ndelt * BACK_ETA) >> 9))
    k_arr = torch.arange(2, device=dev)[:, None]
    ch_arr = torch.arange(6, device=dev)[None, :]
    nmk3 = torch.maximum(nmk3, ((k_arr + 5) * 128).to(I32))
    nmk3 = torch.minimum(nmk3, ((72 + k_arr - ch_arr) * 128).to(I32))
    new_noise_means = nmk3

    # Speech mean and std update (speech frames).
    delt_s = _s16((sgprvec * delta_s) >> 11)
    t16 = _s16((delt_s * SPEECH_UPDATE_CONST) >> 21)
    smk2 = _s16(smk + ((t16 + 1) >> 1))
    smk2 = torch.maximum(smk2, const(MINIMUM_MEAN, I32, dev)[:, None])
    # ``maxspe`` is loop-carried in C: channel 0 uses the initial 12800,
    # channel ch uses kMaximumSpeech[ch - 1] (vad_core.c:289, 429).
    maxspe_prev = const((12800,) + MAXIMUM_SPEECH[:-1], I32, dev)
    smk2 = torch.minimum(smk2, maxspe_prev + 640)
    new_speech_means = torch.where(vf, smk2, smk)

    t_s = _s16(feat - ((smk + 4) >> 3))  # Q4
    t1_32 = (delta_s * t_s) >> 3
    t2_32 = t1_32 - 4096
    t_16 = sgprvec >> 2
    t1_32 = t_16 * t2_32
    t2_32 = t1_32 >> 4  # Q20
    div = spl.div_w32_w16(torch.abs(t2_32), torch.clamp(ssk * 10, min=1))
    t_16 = torch.where(t2_32 > 0, div, -div) + 128
    ssk2 = torch.clamp(ssk + (t_16 >> 8), min=MIN_STD)
    new_speech_stds = torch.where(vf, ssk2, ssk)

    # Noise std update (frames without speech).
    t_s = _s16(feat - (nmk >> 3))
    t1_32 = ((delta_n * t_s) >> 3) - 4096
    t_16 = (ngprvec + 2) >> 2
    t2_32 = t_16 * t1_32  # wraps like OverflowingMulS16ByS32ToS32
    t1_32 = t2_32 >> 14
    div = spl.div_w32_w16(torch.abs(t1_32), torch.clamp(nsk, min=1))
    t_16 = torch.where(t1_32 > 0, div, -div) + 32
    nsk2 = torch.clamp(nsk + (t_16 >> 6), min=MIN_STD)
    new_noise_stds = torch.where(vf, nsk, nsk2)

    # Separate the models if they are too close (vad_core.c:391-427).
    nm, noise_gmean = _weighted_average(new_noise_means, 0, nw)
    sm, speech_gmean = _weighted_average(new_speech_means, 0, sw)
    min_diff = const(MINIMUM_DIFFERENCE, I32, dev)
    diff = _s16(speech_gmean >> 9) - _s16(noise_gmean >> 9)
    need = diff < min_diff
    gap = min_diff - diff
    up_s = _s16((13 * gap) >> 2)
    down_n = _s16((3 * gap) >> 2)
    sm2, speech_gmean2 = _weighted_average(
        sm, torch.where(need, up_s, 0)[:, None, :], sw)
    nm2, noise_gmean2 = _weighted_average(
        nm, torch.where(need, -down_n, 0)[:, None, :], nw)

    # Clamp the global means (vad_core.c:429-448).
    over_s = (_s16(speech_gmean2 >> 7)
              - const(MAXIMUM_SPEECH, I32, dev))[:, None, :]
    sm3 = torch.where(over_s > 0, sm2 - over_s, sm2)
    over_n = (_s16(noise_gmean2 >> 7)
              - const(MAXIMUM_NOISE, I32, dev))[:, None, :]
    nm3 = torch.where(over_n > 0, nm2 - over_n, nm2)

    pk = power_ok[:, None, None]

    def sel(new, old):
        return torch.where(pk, new, old).to(I32)

    state = state.replace(
        noise_means=sel(nm3, state.noise_means),
        speech_means=sel(sm3, state.speech_means),
        noise_stds=sel(new_noise_stds, state.noise_stds),
        speech_stds=sel(new_speech_stds, state.speech_stds),
        frame_counter=state.frame_counter + power_ok.to(I32),
    )

    # Hysteresis (vad_core.c:455-471).
    new_num = torch.where(
        vadflag, torch.clamp(state.num_of_speech + 1, max=MAX_SPEECH_FRAMES),
        0).to(I32)
    hit_max = vadflag & (state.num_of_speech + 1 > MAX_SPEECH_FRAMES)
    new_over = torch.where(vadflag, torch.where(hit_max, oh2, oh1),
                           torch.clamp(state.over_hang - 1, min=0)).to(I32)
    out_flag = torch.where(vadflag, 1, torch.where(
        state.over_hang > 0, 2 + state.over_hang, 0))
    state = state.replace(over_hang=new_over, num_of_speech=new_num)
    return state, out_flag


def process(state: VadState, audio, sample_rate_hz: int, mode: int = 0):
    """WebRtcVad_Process (webrtc_vad.c:56-91) at 8, 16 or 32 kHz.

    audio: (N, L) int16-valued int32, L = 10/20/30 ms at the rate.
    Returns (state, vad (N,) int32 in {0, 1})."""
    n = audio.shape[1]
    ds = state.downsampling_filter_states
    if sample_rate_hz == 32000:
        wb, st2 = downsample_by_2(audio, ds[:, 2:])
        nb, st1 = downsample_by_2(wb, ds[:, :2])
        state = state.replace(
            downsampling_filter_states=torch.cat([st1, st2], -1))
        n8 = n // 4
    elif sample_rate_hz == 16000:
        nb, st1 = downsample_by_2(audio, ds[:, :2])
        state = state.replace(
            downsampling_filter_states=torch.cat([st1, ds[:, 2:]], -1))
        n8 = n // 2
    elif sample_rate_hz == 8000:
        nb = audio
        n8 = n
    else:
        raise ValueError("the legacy VAD core supports 8/16/32 kHz input")

    frame_index = {80: 0, 160: 1, 240: 2}[n8]
    state, features, total_power = calculate_features(state, nb, n8)
    state, flag = gmm_probability(state, features, total_power, frame_index,
                                  mode)
    return state, (flag > 0).to(I32)


class LegacyVad(nn.Module):
    """The GMM VAD at one rate and aggressiveness mode; its constant
    tables come from ``ops.batch.const`` on the state's device."""

    def __init__(self, sample_rate_hz: int, mode: int = 0):
        super().__init__()
        if sample_rate_hz not in (8000, 16000, 32000):
            raise ValueError("the legacy VAD core supports 8/16/32 kHz")
        self.sample_rate_hz = sample_rate_hz
        self.mode = mode

    def forward(self, state: VadState, audio: torch.Tensor):
        return process(state, audio, self.sample_rate_hz, self.mode)
