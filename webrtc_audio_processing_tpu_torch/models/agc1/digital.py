"""Legacy fixed-point digital AGC (the Q-math twin).

Port of ``webrtc_audio_processing_tpu/models/agc1/digital.py`` (reference:
agc/legacy/digital_agc.{h,cc}): the compressor gain table
(WebRtcAgc_CalculateGainTable, exact ints in numpy, a copy of the JAX
package's), the energy-level AgcVad, the per-millisecond gain computation
(WebRtcAgc_ComputeDigitalGains) and the gain application
(WebRtcAgc_ApplyDigitalGains), bit for bit on (N, ...) int32 rows.

The overload limiter inside the gain computation, a loop of -0.1 dB steps
whose length depends on the data, runs on the hand-written kernel
``ops/cuda_agc1_limiter.py`` on the card (its plain twin on the CPU); the
per-sample VAD and the per-subframe capacitor recurrences are Python loops
over (N,) rows.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from webrtc_audio_processing_tpu_torch.ops import cuda_agc1_limiter, spl

I32 = torch.int32

# Modes (gain_control.h).
AGC_MODE_UNCHANGED = 0
AGC_MODE_ADAPTIVE_ANALOG = 1
AGC_MODE_ADAPTIVE_DIGITAL = 2
AGC_MODE_FIXED_DIGITAL = 3

_GEN_FUNC_TABLE = np.array([
    256, 485, 786, 1126, 1484, 1849, 2217, 2586, 2955, 3324, 3693,
    4063, 4432, 4801, 5171, 5540, 5909, 6279, 6648, 7017, 7387, 7756,
    8125, 8495, 8864, 9233, 9603, 9972, 10341, 10711, 11080, 11449, 11819,
    12188, 12557, 12927, 13296, 13665, 14035, 14404, 14773, 15143, 15512,
    15881, 16251, 16620, 16989, 17359, 17728, 18097, 18466, 18836, 19205,
    19574, 19944, 20313, 20682, 21052, 21421, 21790, 22160, 22529, 22898,
    23268, 23637, 24006, 24376, 24745, 25114, 25484, 25853, 26222, 26592,
    26961, 27330, 27700, 28069, 28438, 28808, 29177, 29546, 29916, 30285,
    30654, 31024, 31393, 31762, 32132, 32501, 32870, 33240, 33609, 33978,
    34348, 34717, 35086, 35456, 35825, 36194, 36564, 36933, 37302, 37672,
    38041, 38410, 38780, 39149, 39518, 39888, 40257, 40626, 40996, 41365,
    41734, 42104, 42473, 42842, 43212, 43581, 43950, 44320, 44689, 45058,
    45428, 45797, 46166, 46536, 46905], dtype=np.int64)


def _i32(x):
    return int(np.int32(np.int64(x) & 0xFFFFFFFF))


def _norm_w32(x):
    if x == 0:
        return 0
    ax = ~x if x < 0 else x
    n = 0
    while not ((ax << n) & 0x40000000):
        n += 1
    return n


def calculate_gain_table(dig_comp_gain_db: int, target_level_dbfs: int,
                         limiter_enable: bool,
                         analog_target: int) -> np.ndarray:
    """WebRtcAgc_CalculateGainTable (digital_agc.cc:63-235), exact ints.

    Returns the (32,) int32 Q16 gain table."""
    kLog10, kLog10_2, kLogE_1 = 54426, 49321, 23637
    kCompRatio = 3
    limiter_offset = 0

    tmp32no1 = (dig_comp_gain_db - analog_target) * (kCompRatio - 1)
    tmp16no1 = analog_target - target_level_dbfs
    tmp16no1 += int((tmp32no1 + (kCompRatio >> 1)) / kCompRatio)
    max_gain = max(tmp16no1, analog_target - target_level_dbfs)

    tmp32no1 = dig_comp_gain_db * (kCompRatio - 1)
    diff_gain = int((tmp32no1 + (kCompRatio >> 1)) / kCompRatio)
    if diff_gain < 0 or diff_gain >= len(_GEN_FUNC_TABLE):
        raise ValueError("bad diff_gain")

    limiter_lvl_x = analog_target - limiter_offset
    limiter_idx = 2 + int((limiter_lvl_x * (1 << 13)) / (kLog10_2 / 2))
    tmp16no1 = int((limiter_offset + (kCompRatio >> 1)) / kCompRatio)
    limiter_lvl = target_level_dbfs + tmp16no1

    const_max_gain = int(_GEN_FUNC_TABLE[diff_gain])
    const_lin_approx = 22817
    den = 20 * const_max_gain

    table = np.zeros(32, np.int64)
    for i in range(32):
        tmp16 = (kCompRatio - 1) * (i - 1)
        tmp32 = tmp16 * kLog10_2 + 1
        in_level = int(tmp32 / kCompRatio)
        in_level = diff_gain * (1 << 14) - in_level
        abs_in = abs(in_level)
        int_part = abs_in >> 14
        frac_part = abs_in & 0x3FFF
        t16 = int(_GEN_FUNC_TABLE[int_part + 1] - _GEN_FUNC_TABLE[int_part])
        u1 = t16 * frac_part
        u1 += int(_GEN_FUNC_TABLE[int_part]) << 14
        log_approx = u1 >> 8
        if in_level < 0:
            zeros = 32 - abs_in.bit_length() if abs_in else 32
            zeros_scale = 0
            if zeros < 15:
                u2 = abs_in >> (15 - zeros)
                u2 = u2 * kLogE_1
                if zeros < 9:
                    zeros_scale = 9 - zeros
                    u1 >>= zeros_scale
                else:
                    u2 >>= zeros - 9
            else:
                u2 = (abs_in * kLogE_1) >> 6
            log_approx = 0
            if u2 < u1:
                log_approx = (u1 - u2) >> (8 - zeros_scale)
        num_fix = (max_gain * const_max_gain) * (1 << 6)
        num_fix -= log_approx * diff_gain

        if num_fix > (den >> 8) or -num_fix > (den >> 8):
            zeros = _norm_w32(_i32(num_fix))
        else:
            zeros = _norm_w32(_i32(den)) + 8
        num_fix = _i32(num_fix * (1 << zeros))
        shifted = den << (zeros - 9) if zeros >= 9 else den >> (9 - zeros)
        y32 = int(num_fix / shifted) if shifted else 0
        y32 = (y32 + 1) >> 1 if y32 >= 0 else -((-y32 + 1) >> 1)

        if limiter_enable and i < limiter_idx:
            tmp32 = (i - 1) * kLog10_2 - limiter_lvl * (1 << 14)
            y32 = int((tmp32 + 10) / 20)
        if y32 > 39000:
            tmp32 = ((y32 >> 1) * kLog10 + 4096) >> 13
        else:
            tmp32 = (y32 * kLog10 + 8192) >> 14
        tmp32 += 16 << 14

        if tmp32 > 0:
            int_part = tmp32 >> 14
            frac_part = tmp32 & 0x3FFF
            if frac_part >> 13:
                t16 = (2 << 14) - const_lin_approx
                t2 = ((1 << 14) - frac_part) * t16
                t2 >>= 13
                t2 = (1 << 14) - t2
            else:
                t16 = const_lin_approx - (1 << 14)
                t2 = (frac_part * t16) >> 13
            frac_part = t2
            if int_part >= 14:
                table[i] = _i32((1 << int_part)
                                + (frac_part << (int_part - 14)))
            else:
                table[i] = _i32((1 << int_part)
                                + (frac_part >> (14 - int_part)))
        else:
            table[i] = 0
    return table.astype(np.int32)


# ----------------------------------------------------------------- AgcVad


@dataclass
class AgcVadState:
    """AgcVad (digital_agc.h:19-30); leaves (N, ...)."""

    down_state: torch.Tensor  # (N, 8) int32
    hp_state: torch.Tensor  # (N,) int32 (int16 range)
    counter: torch.Tensor  # (N,) int32
    log_ratio: torch.Tensor  # (N,) int32 Q10
    mean_long_term: torch.Tensor  # Q10
    variance_long_term: torch.Tensor  # Q8
    std_long_term: torch.Tensor  # Q10
    mean_short_term: torch.Tensor  # Q10
    variance_short_term: torch.Tensor  # Q8
    std_short_term: torch.Tensor  # Q10

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def _full(batch, v, device, shape=()):
    return torch.full((batch,) + shape, v, dtype=I32, device=device)


def init_vad(batch: int, device) -> AgcVadState:
    return AgcVadState(
        down_state=_full(batch, 0, device, (8,)),
        hp_state=_full(batch, 0, device),
        counter=_full(batch, 3, device),
        log_ratio=_full(batch, 0, device),
        mean_long_term=_full(batch, 15 << 10, device),
        variance_long_term=_full(batch, 500 << 8, device),
        std_long_term=_full(batch, 0, device),
        mean_short_term=_full(batch, 15 << 10, device),
        variance_short_term=_full(batch, 500 << 8, device),
        std_short_term=_full(batch, 0, device),
    )


def process_vad(state: AgcVadState, x: torch.Tensor):
    """WebRtcAgc_ProcessVad (digital_agc.cc:576-707).

    x: (N, 160) or (N, 80) int32 samples (int16-valued: the 16 kHz band or
    the 8 kHz frame). Returns (state, log_ratio (N,))."""
    if x.shape[1] == 160:
        pairs = (x[:, 0::2] + x[:, 1::2]) >> 1  # average to 8 kHz
    else:
        pairs = x
    buf2, down_state = spl.downsample_by_2(pairs, state.down_state)

    # High-pass and energy, sample by sample at 4 kHz.
    hp = state.hp_state
    nrg = torch.zeros_like(hp)
    for k in range(buf2.shape[1]):
        b = buf2[:, k]
        out = b + hp
        hp = ((600 * out) >> 10) - b
        nrg = nrg + out * (out // 64) + (out * torch.remainder(out, 64)) // 64

    zeros = torch.clamp(spl.norm_u32(nrg), max=31)
    dB = (15 - zeros) * (1 << 11)
    w16 = spl.wrap_i16

    # The counter increments before the long-term updates
    # (digital_agc.cc:646-649).
    counter = torch.clamp(state.counter + 1, max=250)  # kAvgDecayTime
    mean_st = w16((state.mean_short_term * 15 + dB) >> 4)
    var_st = ((dB * dB) >> 12) + state.variance_short_term * 15
    var_st = var_st // 16
    std_st = w16(spl.sqrt_i32(var_st * 4096 - mean_st * mean_st))

    mean_lt = w16(spl.div_w32_w16(state.mean_long_term * counter + dB,
                                  counter + 1))
    var_lt = spl.div_w32_w16(
        ((dB * dB) >> 12) + state.variance_long_term * counter, counter + 1)
    std_lt = w16(spl.sqrt_i32(var_lt * 4096 - mean_lt * mean_lt))

    # (dB - meanLongTerm) is narrowed to int16 before the multiply, the
    # reference's deliberate wrap (digital_agc.cc:683-689).
    tmp32 = (3 << 12) * w16(dB - mean_lt)
    tmp32 = spl.div_w32_w16(tmp32, torch.clamp(std_lt, min=1))
    tmp32b = state.log_ratio * (13 << 12)
    total = (tmp32 + (tmp32b >> 10)) >> 6
    log_ratio = w16(torch.clamp(total, -2048, 2048)).to(I32)

    return (
        state.replace(
            down_state=down_state,
            hp_state=hp,
            counter=counter,
            log_ratio=log_ratio,
            mean_long_term=mean_lt,
            variance_long_term=var_lt,
            std_long_term=std_lt,
            mean_short_term=mean_st,
            variance_short_term=var_st,
            std_short_term=std_st,
        ),
        log_ratio,
    )


# ----------------------------------------------------------- digital AGC


@dataclass
class DigitalAgcState:
    """DigitalAgc (digital_agc.h:32-44); leaves (N, ...)."""

    capacitor_slow: torch.Tensor  # (N,) int32
    capacitor_fast: torch.Tensor
    gain: torch.Tensor
    gate_previous: torch.Tensor
    vad_nearend: AgcVadState
    vad_farend: AgcVadState

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def init_digital(agc_mode: int, batch: int, device) -> DigitalAgcState:
    return DigitalAgcState(
        capacitor_slow=_full(
            batch, 0 if agc_mode == AGC_MODE_FIXED_DIGITAL else 134217728,
            device),
        capacitor_fast=_full(batch, 0, device),
        gain=_full(batch, 65536, device),
        gate_previous=_full(batch, 0, device),
        vad_nearend=init_vad(batch, device),
        vad_farend=init_vad(batch, device),
    )


def add_farend(state: DigitalAgcState, far: torch.Tensor):
    """WebRtcAgc_AddFarendToDigital (digital_agc.cc:258-266)."""
    vad, _ = process_vad(state.vad_farend, far)
    return state.replace(vad_farend=vad)


def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[n, idx[n]] for a (N, 32) or (32,) table and (N,) indices."""
    if table.dim() == 1:
        return table[idx.long()]
    return torch.gather(table, 1, idx.long()[:, None])[:, 0]


def compute_digital_gains(state: DigitalAgcState, band0: torch.Tensor,
                          agc_mode: int, gain_table: torch.Tensor,
                          low_level_signal: torch.Tensor):
    """WebRtcAgc_ComputeDigitalGains (digital_agc.cc:269-466).

    band0: (N, 160) int32 16 kHz band samples (or (N, 80) at 8 kHz);
    gain_table: (32,) or per-row (N, 32) int32. Returns (state, gains
    (N, 11) int32)."""
    N, n = band0.shape
    L = n // 10

    vad_ne, logratio = process_vad(state.vad_nearend, band0)

    # Far-end VAD discount.
    logratio = torch.where(
        state.vad_farend.counter > 10,
        (3 * logratio - state.vad_farend.log_ratio) >> 2, logratio)

    upper_thr, lower_thr = 1024, 0
    decay = torch.where(
        logratio > upper_thr, -65,
        torch.where(logratio < lower_thr, 0,
                    ((lower_thr - logratio) * 65) >> 10)).to(I32)

    if agc_mode != AGC_MODE_FIXED_DIGITAL:
        std_lt = vad_ne.std_long_term
        decay = torch.where(
            std_lt < 4000, 0,
            torch.where(std_lt < 8096, ((std_lt - 4000) * decay) >> 12,
                        decay)).to(I32)
        decay = torch.where(low_level_signal, 0, decay).to(I32)

    env = torch.amax((band0 * band0).reshape(N, 10, L), dim=2)  # (N, 10)

    cap_fast, cap_slow = state.capacitor_fast, state.capacitor_slow
    g_list, zeros = [], None
    frac = None
    for k in range(10):
        e = env[:, k]
        cap_fast = spl.agc_scalediff32(-1000, cap_fast, cap_fast)
        cap_fast = torch.maximum(cap_fast, e)
        cap_slow = torch.where(
            e > cap_slow, spl.agc_scalediff32(500, e - cap_slow, cap_slow),
            spl.agc_scalediff32(decay, cap_slow, cap_slow))
        cur = torch.maximum(cap_fast, cap_slow)
        zeros = torch.where(cur == 0, 31, spl.norm_u32(cur)).to(I32)
        tmp = spl.shl_u32(cur, zeros) & 0x7FFFFFFF
        frac = tmp >> 19  # Q12
        g_z = _take(gain_table, zeros)
        diff = _take(gain_table, torch.clamp(zeros - 1, min=0)) - g_z
        g_list.append(g_z + ((diff >> 12) * frac
                             + (((diff & 0xFFF) * frac) >> 12)))
    gains = torch.stack([state.gain] + g_list, 1)  # (N, 11)

    # Gate processing (:396-437).
    zeros_q = zeros * 512 - (frac >> 3)
    zeros_fast = torch.where(cap_fast == 0, 31,
                             spl.norm_u32(cap_fast)).to(I32)
    tmpf = spl.shl_u32(cap_fast, zeros_fast) & 0x7FFFFFFF
    zeros_fast = zeros_fast * 512 - (tmpf >> 22)
    gate = 1000 + zeros_fast - zeros_q - vad_ne.std_short_term

    gate_prev = torch.where(gate < 0, 0,
                            (gate + state.gate_previous * 7) >> 3).to(I32)
    gate = torch.where(gate < 0, gate, gate_prev)
    gain_adj = torch.where(
        gate > 0, torch.where(gate < 2500, (2500 - gate) >> 5, 0), 0)
    do_gate = (gate > 0)[:, None]
    g0 = _take(gain_table, torch.zeros(N, dtype=I32,
                                       device=band0.device))[:, None]
    rest = gains[:, 1:]
    big = (rest - g0) > 8388608
    ga = (178 + gain_adj)[:, None]
    adj = torch.where(big, ((rest - g0) >> 8) * ga,
                      ((rest - g0) * ga) >> 8)
    gains = torch.cat([gains[:, :1], torch.where(do_gate, g0 + adj, rest)],
                      1).to(I32)

    # Overload limiting (:439-476) and the gain reductions 1 ms earlier
    # (:478-483), on the limiter kernel.
    gains = cuda_agc1_limiter.limit(gains, env)

    new_state = state.replace(
        capacitor_slow=cap_slow,
        capacitor_fast=cap_fast,
        gain=gains[:, 10].contiguous(),
        gate_previous=gate_prev,
        vad_nearend=vad_ne,
    )
    return new_state, gains


def _prod_shift16(a, b):
    """(a * b) >> 16 exactly for |a| <= 2^15, by the hi/lo split of b."""
    return a * (b >> 16) + ((a * (b & 0xFFFF)) >> 16)


def apply_digital_gains(gains: torch.Tensor, bands: torch.Tensor):
    """WebRtcAgc_ApplyDigitalGains (digital_agc.cc:485-556).

    gains: (N, 11) int32; bands: (N, num_bands, L) int32 samples. Returns
    (N, num_bands, L) int32."""
    n = bands.shape[-1]
    L = n // 10
    L2 = 3 if L == 8 else 4
    deltas = (gains[:, 1:] - gains[:, :10]) * (1 << (4 - L2))  # (N, 10)
    base = gains[:, :10] * 16
    samples = torch.arange(L, dtype=I32, device=gains.device)
    gain32 = (base[:, :, None] + deltas[:, :, None] * samples).reshape(
        gains.shape[0], 1, n)

    # The first subframe probes for overload and saturates to the extremes
    # (:520-534); the rest saturate normally (:537-555).
    g_first = gain32[..., :L]
    x_first = bands[..., :L]
    probe = _prod_shift16(x_first, (g_first + 127) >> 7)
    exact = _prod_shift16(x_first, g_first >> 4)
    y_first = torch.where(probe > 4095, 32767,
                          torch.where(probe < -4096, -32768, exact))
    rest = _prod_shift16(bands[..., L:], gain32[..., L:] >> 4)
    y_rest = torch.clamp(rest, -32768, 32767)
    return torch.cat([y_first, y_rest], -1).to(I32)
