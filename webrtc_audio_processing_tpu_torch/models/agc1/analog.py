"""Legacy analog AGC: the mic volume recommendation loop (Q-math twin).

Port of ``webrtc_audio_processing_tpu/models/agc1/analog.py`` (reference:
agc/legacy/analog_agc.{h,cc}: WebRtcAgc_Init, AddMic, AddFarend,
VirtualMic, ProcessAnalog, Analyze), bit for bit on (N, ...) int32 rows.
The per-5-subframe decision loop (analog_agc.cc:668-867) is a Python loop
of five steps with branch predication; VirtualMic's per-sample clip
back-off is a loop over the frame's samples; the saturation, zero and
speaker-inactive controls and the Rxx energy trackers keep the reference's
integer arithmetic.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from webrtc_audio_processing_tpu_torch.models.agc1 import digital
from webrtc_audio_processing_tpu_torch.ops import spl
from webrtc_audio_processing_tpu_torch.ops.batch import const, tree_where

I32 = torch.int32

RXX_BUFFER_LEN = 10
ALPHA_SHORT = 6
ALPHA_LONG = 10
MSEC_INNER = 520
MSEC_OUTER = 340
NORMAL_VAD_THRESHOLD = 400
MUTE_GUARD_MS = 8000

_SLOPE1 = np.array([21793, 12517, 7189, 4129, 2372, 1362, 472, 78])
_OFFSET1 = np.array([25395, 23911, 22206, 20737, 19612, 18805, 17951, 17367])
_SLOPE2 = np.array([2063, 1731, 1452, 1218, 1021, 857, 597, 337])
_OFFSET2 = np.array([18432, 18379, 18290, 18177, 18052, 17920, 17670, 17286])

GAIN_TABLE_ANALOG = np.array([
    4096, 4251, 4412, 4579, 4752, 4932, 5118, 5312, 5513, 5722, 5938,
    6163, 6396, 6638, 6889, 7150, 7420, 7701, 7992, 8295, 8609, 8934,
    9273, 9623, 9987, 10365, 10758, 11165, 11587, 12025, 12480, 12953],
    np.int32)

GAIN_TABLE_VIRTUAL_MIC = np.array([
    1052, 1081, 1110, 1141, 1172, 1204, 1237, 1271, 1305, 1341, 1378,
    1416, 1454, 1494, 1535, 1577, 1620, 1664, 1710, 1757, 1805, 1854,
    1905, 1957, 2010, 2065, 2122, 2180, 2239, 2301, 2364, 2428, 2495,
    2563, 2633, 2705, 2779, 2855, 2933, 3013, 3096, 3180, 3267, 3357,
    3449, 3543, 3640, 3739, 3842, 3947, 4055, 4166, 4280, 4397, 4517,
    4640, 4767, 4898, 5032, 5169, 5311, 5456, 5605, 5758, 5916, 6078,
    6244, 6415, 6590, 6770, 6956, 7146, 7341, 7542, 7748, 7960, 8178,
    8402, 8631, 8867, 9110, 9359, 9615, 9878, 10148, 10426, 10711, 11004,
    11305, 11614, 11932, 12258, 12593, 12938, 13292, 13655, 14029, 14412,
    14807, 15212, 15628, 16055, 16494, 16945, 17409, 17885, 18374, 18877,
    19393, 19923, 20468, 21028, 21603, 22194, 22801, 23425, 24065, 24724,
    25400, 26095, 26808, 27541, 28295, 29069, 29864, 30681, 31520, 32382],
    np.int32)

SUPPRESSION_TABLE_VIRTUAL_MIC = np.array([
    1024, 1006, 988, 970, 952, 935, 918, 902, 886, 870, 854, 839, 824, 809,
    794, 780, 766, 752, 739, 726, 713, 700, 687, 675, 663, 651, 639, 628,
    616, 605, 594, 584, 573, 563, 553, 543, 533, 524, 514, 505, 496, 487,
    478, 470, 461, 453, 445, 437, 429, 421, 414, 406, 399, 392, 385, 378,
    371, 364, 358, 351, 345, 339, 333, 327, 321, 315, 309, 304, 298, 293,
    288, 283, 278, 273, 268, 263, 258, 254, 249, 244, 240, 236, 232, 227,
    223, 219, 215, 211, 208, 204, 200, 197, 193, 190, 186, 183, 180, 176,
    173, 170, 167, 164, 161, 158, 155, 153, 150, 147, 145, 142, 139, 137,
    134, 132, 130, 127, 125, 123, 121, 118, 116, 114, 112, 110, 108, 106,
    104, 102], np.int32)

TARGET_LEVEL_TABLE = np.array([
    134209536, 106606424, 84680493, 67264106, 53429779, 42440782, 33711911,
    26778323, 21270778, 16895980, 13420954, 10660642, 8468049, 6726411,
    5342978, 4244078, 3371191, 2677832, 2127078, 1689598, 1342095, 1066064,
    846805, 672641, 534298, 424408, 337119, 267783, 212708, 168960, 134210,
    106606, 84680, 67264, 53430, 42441, 33712, 26778, 21271, 16896, 13421,
    10661, 8468, 6726, 5343, 4244, 3371, 2678, 2127, 1690, 1342, 1066, 847,
    673, 534, 424, 337, 268, 213, 169, 134, 107, 85, 67], np.int64)


def _tab(arr) -> tuple:
    return tuple(int(v) for v in arr)


class LegacyAgcConfig:
    """The static outputs of Init and set_config (analog_agc.cc:1044-1100
    and WebRtcAgc_UpdateAgcThresholds :359-397)."""

    def __init__(self, min_level=0, max_level=255,
                 agc_mode=digital.AGC_MODE_ADAPTIVE_ANALOG, fs=16000,
                 target_level_dbfs=3, compression_gain_db=9,
                 limiter_enable=True):
        if agc_mode == digital.AGC_MODE_ADAPTIVE_DIGITAL:
            min_level, max_level = 0, 255
        self.agc_mode = agc_mode
        self.fs = fs
        self.scale = 0
        max_add = (max_level - min_level) // 4
        self.min_level = min_level
        self.max_analog = max_level
        self.max_level = max_level + max_add
        self.max_init = self.max_level
        self.min_output = min_level + (((self.max_level - min_level) * 10)
                                       >> 8)
        self.target_level_dbfs = target_level_dbfs
        self.limiter_enable = limiter_enable
        comp = compression_gain_db
        if agc_mode == digital.AGC_MODE_FIXED_DIGITAL:
            comp += target_level_dbfs
        self.compression_gain_db = comp

        # UpdateAgcThresholds.
        tmp16 = int((5 * comp + 5) / 11)
        self.analog_target = max(4 + tmp16, 4)
        if agc_mode == digital.AGC_MODE_FIXED_DIGITAL:
            self.analog_target = comp
        self.target_idx = 11 + 9  # ANALOG_TARGET_LEVEL + OFFSET_ENV_TO_RMS
        t = self.target_idx
        tab = TARGET_LEVEL_TABLE
        self.analog_target_level = int(RXX_BUFFER_LEN * tab[t])
        self.start_upper_limit = int(RXX_BUFFER_LEN * tab[t - 1])
        self.start_lower_limit = int(RXX_BUFFER_LEN * tab[t + 1])
        self.upper_primary_limit = int(RXX_BUFFER_LEN * tab[t - 2])
        self.lower_primary_limit = int(RXX_BUFFER_LEN * tab[t + 2])
        self.upper_secondary_limit = int(RXX_BUFFER_LEN * tab[t - 5])
        self.lower_secondary_limit = int(RXX_BUFFER_LEN * tab[t + 5])

        self.gain_table = digital.calculate_gain_table(
            comp, target_level_dbfs, limiter_enable, self.analog_target)


@dataclass
class AnalogAgcState:
    """LegacyAgc (analog_agc.h:46-118); leaves (N, ...)."""

    digital: digital.DigitalAgcState
    vad_mic: digital.AgcVadState
    env: torch.Tensor  # (N, 2, 10) int32
    rxx16w32: torch.Tensor  # (N, 2, 5) int32
    in_queue: torch.Tensor  # (N,) int32
    filter_state: torch.Tensor  # (N, 8) int32
    env_sum: torch.Tensor
    mic_vol: torch.Tensor
    max_level: torch.Tensor  # can be raised
    mic_ref: torch.Tensor
    mic_gain_idx: torch.Tensor
    gain_table_idx: torch.Tensor
    last_in_mic_level: torch.Tensor
    first_call: torch.Tensor  # (N,) bool
    ms_zero: torch.Tensor
    ms_too_low: torch.Tensor
    ms_too_high: torch.Tensor
    change_to_slow_mode: torch.Tensor
    msec_inner: torch.Tensor
    msec_outer: torch.Tensor
    active_speech: torch.Tensor
    mute_guard_ms: torch.Tensor
    zero_ctrl_max: torch.Tensor
    vad_threshold: torch.Tensor
    low_level_signal: torch.Tensor  # (N,) bool
    upper_limit: torch.Tensor
    lower_limit: torch.Tensor
    rxx160w32: torch.Tensor
    rxx16_lpw32: torch.Tensor
    rxx160_lpw32: torch.Tensor
    rxx16_lpw32_max: torch.Tensor
    rxx16_vector: torch.Tensor  # (N, 10) int32
    rxx16_pos: torch.Tensor

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def init_state(cfg: LegacyAgcConfig, batch: int, device) -> AnalogAgcState:
    mic_vol = cfg.max_analog
    if cfg.agc_mode == digital.AGC_MODE_ADAPTIVE_DIGITAL:
        mic_vol = 127

    def full(v, shape=(), dtype=I32):
        return torch.full((batch,) + shape, v, dtype=dtype, device=device)

    return AnalogAgcState(
        digital=digital.init_digital(cfg.agc_mode, batch, device),
        vad_mic=digital.init_vad(batch, device),
        env=full(0, (2, 10)),
        rxx16w32=full(0, (2, 5)),
        in_queue=full(0),
        filter_state=full(0, (8,)),
        env_sum=full(0),
        mic_vol=full(mic_vol),
        max_level=full(cfg.max_level),
        mic_ref=full(mic_vol),
        mic_gain_idx=full(127),
        gain_table_idx=full(0),
        last_in_mic_level=full(0),
        first_call=full(False, dtype=torch.bool),
        ms_zero=full(0),
        ms_too_low=full(0),
        ms_too_high=full(0),
        change_to_slow_mode=full(0),
        msec_inner=full(MSEC_INNER),
        msec_outer=full(MSEC_OUTER),
        active_speech=full(0),
        mute_guard_ms=full(0),
        zero_ctrl_max=full(cfg.max_analog),
        vad_threshold=full(NORMAL_VAD_THRESHOLD),
        low_level_signal=full(False, dtype=torch.bool),
        upper_limit=full(cfg.start_upper_limit),
        lower_limit=full(cfg.start_lower_limit),
        rxx160w32=full(125 * RXX_BUFFER_LEN),
        rxx16_lpw32=full(16284),
        rxx160_lpw32=full(cfg.analog_target_level),
        rxx16_lpw32_max=full(0),
        rxx16_vector=full(1000, (10,)),
        rxx16_pos=full(0),
    )


def _w(cond, a, b):
    """torch.where to int32."""
    return torch.where(cond, a, b).to(I32)


def _set_slot(buf, slot, row):
    """buf[n, slot[n]] = row[n] for buf (N, 2, K)."""
    pick = torch.arange(2, device=buf.device) == slot[:, None]
    return torch.where(pick[:, :, None], row[:, None, :], buf)


def add_far_end(state: AnalogAgcState, far):
    """WebRtcAgc_AddFarend (analog_agc.cc:207-217)."""
    return state.replace(digital=digital.add_farend(state.digital, far))


def add_mic(cfg: LegacyAgcConfig, state: AnalogAgcState, bands):
    """WebRtcAgc_AddMic (analog_agc.cc:99-205).

    bands: (N, num_bands, L) int32. Returns (state, modified bands)."""
    N, _, n = bands.shape
    L = n // 10
    dev = bands.device

    # Slowly varying digital pre-gain when micVol > maxAnalog (:114-155).
    over = state.mic_vol > cfg.max_analog
    tmp16 = state.mic_vol - cfg.max_analog
    denom = max(cfg.max_level - cfg.max_analog, 1)
    target_idx = (31 * tmp16) // denom
    gidx = _w(over, torch.clamp(
        state.gain_table_idx + torch.sign(target_idx - state.gain_table_idx),
        0, 31), 0)
    gain = const(_tab(GAIN_TABLE_ANALOG), I32, dev)[gidx.long()]
    bands = torch.where(
        over[:, None, None],
        torch.clamp((bands * gain[:, None, None]) >> 12, -32768, 32767),
        bands)

    # Envelope per subframe (:157-173).
    b0 = bands[:, 0]
    env_new = torch.amax((b0 * b0).reshape(N, 10, L), dim=2)
    slot = (state.in_queue > 0).to(I32)
    env = _set_slot(state.env, slot, env_new)

    # Energy in 16-sample blocks at 8 kHz (:175-189).
    if cfg.fs == 16000:
        ds, filter_state = spl.downsample_by_2(b0, state.filter_state)
    else:
        ds, filter_state = b0, state.filter_state
    blocks = ds[:, :5 * 16].reshape(N, 5, 16)
    rxx16 = torch.sum((blocks * blocks) >> 4, dim=2, dtype=I32)
    rxx = _set_slot(state.rxx16w32, slot, rxx16)

    in_queue = _w(state.in_queue == 0, 1, 2)
    vad_mic, _ = digital.process_vad(state.vad_mic, b0)

    return (
        state.replace(env=env, rxx16w32=rxx, in_queue=in_queue,
                      filter_state=filter_state, gain_table_idx=gidx,
                      vad_mic=vad_mic),
        bands,
    )


def virtual_mic(cfg: LegacyAgcConfig, state: AnalogAgcState, bands,
                mic_level_in):
    """WebRtcAgc_VirtualMic (analog_agc.cc:290-408), the adaptive-digital
    front: the low-level-signal decision, the emulated mic gain from the
    virtual gain and suppression tables (with the per-sample clip
    back-off), then AddMic.

    bands: (N, num_bands, L) int32; mic_level_in: (N,) int32. Returns
    (state, bands, mic_level_out (N,))."""
    b0 = bands[:, 0]
    n = b0.shape[1]
    dev = bands.device

    # Low-level-signal decision (:314-344): energy accumulated while below
    # the limit (summands capped at 2^23 so the int32 sum cannot wrap; the
    # cap is far above the limit, so no decision changes), and zero
    # crossings.
    limit = 5500 if cfg.fs == 8000 else 11000
    sq = torch.clamp(b0 * b0, max=1 << 23)
    c = torch.cumsum(sq, dim=1, dtype=I32)
    hit = c >= limit
    k = torch.where(hit.any(1), torch.argmax(hit.to(I32), 1), n - 1)
    frame_nrg = torch.gather(c, 1, k[:, None])[:, 0]
    zc = torch.sum(((b0[:, 1:] ^ b0[:, :-1]) < 0).to(I32), 1, dtype=I32)
    low = torch.where(
        (frame_nrg < 500) | (zc <= 5), True,
        torch.where(zc <= 15, False,
                    torch.where(frame_nrg <= limit, True, zc >= 20)))

    # Restart on a change of the physical level (:345-358).
    mic_level_tmp = mic_level_in.to(I32) << cfg.scale
    restart = mic_level_tmp != state.mic_ref
    mic_vol = _w(restart, 127, state.mic_vol)
    gain_idx = _w(restart, 127, torch.clamp(mic_vol, max=cfg.max_analog))

    gain_tab = const(_tab(GAIN_TABLE_VIRTUAL_MIC), I32, dev)
    supp_tab = const(_tab(SUPPRESSION_TABLE_VIRTUAL_MIC), I32, dev)

    def lookup(g, off):
        return torch.where(
            g > 127 - off, gain_tab[torch.clamp(g - 128 + off, 0, 127).long()],
            supp_tab[torch.clamp(127 - g, 0, 127).long()])

    g = lookup(gain_idx, 0)
    # Sample by sample; after a clip the reference looks up ``gainIdx -
    # 127`` (:370-384), off by one, reproduced.
    outs = []
    for s in range(n):
        x = bands[:, :, s]
        t = (x[:, 0] * g) >> 10
        clipped = (t > 32767) | (t < -32768)
        t = torch.clamp(t, -32768, 32767)
        gain_idx = gain_idx - clipped.to(I32)
        g = torch.where(clipped, lookup(gain_idx, 1), g)
        rest = torch.clamp((x[:, 1:] * g[:, None]) >> 10, -32768, 32767)
        outs.append(torch.cat([t[:, None], rest], 1))
    bands = torch.stack(outs, 2)

    state = state.replace(low_level_signal=low, mic_ref=mic_level_tmp,
                          mic_vol=mic_vol, mic_gain_idx=gain_idx)
    mic_level_out = gain_idx >> cfg.scale
    state, bands = add_mic(cfg, state, bands)
    return state, bands, mic_level_out


def process_analog(cfg: LegacyAgcConfig, state: AnalogAgcState,
                   in_mic_level, echo):
    """WebRtcAgc_ProcessAnalog (analog_agc.cc:527-900).

    in_mic_level: (N,) int32; echo: (N,) tensor or a Python scalar.
    Returns (state,
    out_mic_level (N,), saturation_warning (N,) bool)."""
    dev = in_mic_level.device
    vad_log_ratio = state.vad_mic.log_ratio
    in_lvl = in_mic_level.to(I32)

    # First-call startup volume (:553-568).
    tmp_vol = cfg.min_level + (((cfg.max_level - cfg.min_level) * 51) >> 9)
    first = ~state.first_call
    raise_at_start = (first & (in_lvl < tmp_vol)
                      & (cfg.agc_mode == digital.AGC_MODE_ADAPTIVE_ANALOG))
    in_tmp = _w(raise_at_start, tmp_vol, in_lvl)
    mic_vol = _w(first, in_tmp, state.mic_vol)

    # Digital-gain pass-through and manual-change handling (:570-600).
    in_tmp = _w((in_tmp == cfg.max_analog) & (mic_vol > cfg.max_analog),
                mic_vol, in_tmp)
    low_manual = (in_tmp != mic_vol) & (in_tmp < cfg.min_output)
    in_tmp = _w(low_manual, tmp_vol, in_tmp)
    mic_vol = _w(low_manual, tmp_vol, mic_vol)
    stuck = (in_tmp != mic_vol) & (in_lvl == state.last_in_mic_level)
    in_tmp = _w(stuck, mic_vol, in_tmp)
    mic_vol = _w((in_tmp != mic_vol) & ~stuck, in_tmp, mic_vol)

    max_level = torch.maximum(state.max_level, in_tmp)
    last_mic_vol = mic_vol

    # SaturationCtrl (:399-418).
    envv = state.env[:, 0]
    env16 = envv >> 20
    env_sum = state.env_sum + torch.sum(torch.where(env16 > 875, env16, 0),
                                        1, dtype=I32)
    saturated = env_sum > 25000
    env_sum = _w(saturated, 0, env_sum)
    env_sum = (env_sum * 32440) >> 15

    rxx160_lp = _w(saturated, (state.rxx160_lpw32 // 8) * 7,
                   state.rxx160_lpw32)
    zero_ctrl_max = _w(saturated, mic_vol, state.zero_ctrl_max)
    sat_vol = ((29591 * (in_tmp - cfg.min_level)) >> 15) + cfg.min_level
    sat_vol = torch.minimum(sat_vol, last_mic_vol - 2)
    mic_vol = _w(saturated, sat_vol, mic_vol)
    in_tmp = _w(saturated, mic_vol, in_tmp)
    saturation_warning = saturated & (mic_vol < cfg.min_output)
    ms_too_high = _w(saturated, -100, state.ms_too_high)
    active_speech = _w(saturated, 0, state.active_speech)
    rxx16_max = _w(saturated, 0, state.rxx16_lpw32_max)
    msec_inner = _w(saturated, MSEC_INNER, state.msec_inner)
    msec_outer = _w(saturated, MSEC_OUTER, state.msec_outer)
    change_slow = _w(saturated, 0, state.change_to_slow_mode)
    mute_guard = _w(saturated, 0, state.mute_guard_ms)
    upper_limit = _w(saturated, cfg.start_upper_limit, state.upper_limit)
    lower_limit = _w(saturated, cfg.start_lower_limit, state.lower_limit)

    # ZeroCtrl (:420-466).
    env_total = torch.sum(envv, 1, dtype=I32)
    ms_zero = _w(env_total < 500, state.ms_zero + 10, 0)
    mute_guard = torch.clamp(mute_guard - 10, min=0)
    zero_trip = ms_zero > 500
    ms_zero = _w(zero_trip, 0, ms_zero)
    mid_val = (cfg.max_analog + cfg.min_level + 1) // 2
    raised = torch.minimum((1126 * in_tmp) >> 10, zero_ctrl_max)
    do_raise = zero_trip & (in_tmp < mid_val)
    in_tmp = _w(do_raise, raised, in_tmp)
    mic_vol = _w(do_raise, raised, mic_vol)
    active_speech = _w(zero_trip, 0, active_speech)
    rxx16_max = _w(zero_trip, 0, rxx16_max)
    mute_guard = _w(zero_trip, MUTE_GUARD_MS, mute_guard)

    # SpeakerInactiveCtrl (:468-494).
    std_lt = state.vad_mic.std_long_term
    vad_thr = _w(
        std_lt < 2500, 1500,
        (31 * state.vad_threshold + NORMAL_VAD_THRESHOLD
         + torch.where(std_lt < 4500, (4500 - std_lt) // 2, 0)) >> 5)

    # ExpCurve (:497-524) tables.
    thresholds = const((1311, 2621, 3932, 5243, 6554, 7864, 12124), I32,
                       dev)
    slope1 = const(_tab(_SLOPE1), I32, dev)
    offset1 = const(_tab(_OFFSET1), I32, dev)
    slope2 = const(_tab(_SLOPE2), I32, dev)
    offset2 = const(_tab(_OFFSET2), I32, dev)
    slots = torch.arange(RXX_BUFFER_LEN, device=dev)

    # The main 5-subframe loop (:668-867).
    rxx160 = state.rxx160w32
    rxx16_vec = state.rxx16_vector
    rxx16_pos = state.rxx16_pos
    rxx16_lp = state.rxx16_lpw32
    active = active_speech
    rxx_max = rxx16_max
    ms_hi = ms_too_high
    ms_lo = state.ms_too_low
    chg_slow = change_slow
    m_inner, m_outer = msec_inner, msec_outer
    up_lim, lo_lim = upper_limit, lower_limit
    micv, in_t, maxlev, zc_max = mic_vol, in_tmp, max_level, zero_ctrl_max
    speech = vad_log_ratio > vad_thr
    for k in range(5):
        rxx16w32 = state.rxx16w32[:, 0, k]
        at_pos = slots == rxx16_pos[:, None]
        old = torch.sum(torch.where(at_pos, rxx16_vec, 0), 1, dtype=I32)
        rxx160 = rxx160 + ((rxx16w32 - old) >> 3)
        rxx16_vec = torch.where(at_pos, rxx16w32[:, None], rxx16_vec)
        rxx16_pos = torch.remainder(rxx16_pos + 1, RXX_BUFFER_LEN)
        rxx16_lp = rxx16_lp + ((rxx16w32 - rxx16_lp) >> ALPHA_SHORT)

        # Startup Rxx160_LP capture (:688-699).
        early = active < 250
        rxx_max = _w(speech & early, torch.maximum(rxx_max, rxx16_lp),
                     rxx_max)
        at250 = active == 250
        rxx160_lp = _w(speech & at250, (rxx_max >> 3) * RXX_BUFFER_LEN,
                       rxx160_lp)
        active = _w(speech & (early | at250), active + 2, active)
        rxx160_lp = _w(speech,
                       rxx160_lp + ((rxx160 - rxx160_lp) >> ALPHA_LONG),
                       rxx160_lp)

        b1 = speech & (rxx160_lp > cfg.upper_secondary_limit)
        b2 = speech & ~b1 & (rxx160_lp > up_lim)
        b3 = (speech & ~b1 & ~b2
              & (rxx160_lp < cfg.lower_secondary_limit))
        b4 = speech & ~b1 & ~b2 & ~b3 & (rxx160_lp < lo_lim)
        b5 = speech & ~b1 & ~b2 & ~b3 & ~b4

        ms_hi = _w(b1 | b2, ms_hi + 2, _w(b3 | b4 | b5, 0, ms_hi))
        ms_lo = _w(b3 | b4, ms_lo + 2, _w(b1 | b2 | b5, 0, ms_lo))
        chg_slow = _w(b1 | b2 | b3 | b4, 0, chg_slow)

        # Branches 1 and 2: lower the level (:706-771).
        fire_hi1 = b1 & (ms_hi > m_outer)
        fire_hi2 = b2 & (ms_hi > m_inner)
        fire_hi = fire_hi1 | fire_hi2
        ms_hi = _w(fire_hi, 0, ms_hi)
        rxx160_lp = _w(fire_hi, (rxx160_lp >> 6) * 53, rxx160_lp)
        maxlev = _w(fire_hi,
                    torch.clamp((15 * maxlev + micv) // 16,
                                min=cfg.max_analog), maxlev)
        zc_max = _w(fire_hi, micv, zc_max)
        coef = _w(fire_hi1, 31130, 31621)
        down_vol = ((coef * (in_t - cfg.min_level)) >> 15) + cfg.min_level
        down_vol1 = torch.minimum(down_vol, micv - 2)
        down_vol2 = torch.minimum(down_vol, micv - 1)
        micv = _w(fire_hi1, down_vol1, _w(fire_hi2, down_vol2, micv))
        in_t = _w(fire_hi, micv, in_t)
        active = _w(fire_hi1, 0, active)
        rxx_max = _w(fire_hi1, 0, rxx_max)

        # Branches 3 and 4: raise the level (:773-848).
        fire_lo1 = b3 & (ms_lo > m_outer)
        fire_lo2 = b4 & (ms_lo > m_inner)
        fire_lo = fire_lo1 | fire_lo2
        ms_lo = _w(fire_lo, 0, ms_lo)
        if cfg.max_init != cfg.min_level:
            vol_norm = ((in_t - cfg.min_level) << 14) // (cfg.max_init
                                                          - cfg.min_level)
        else:
            vol_norm = torch.full_like(in_t, 16384)
        index = torch.sum((vol_norm[:, None] > thresholds).to(I32), 1).long()
        w1 = offset1[index] - ((slope1[index] * vol_norm) >> 13)
        w2 = offset2[index] - ((slope2[index] * vol_norm) >> 13)
        rxx160_lp = _w(fire_lo, (rxx160_lp >> 6) * 67, rxx160_lp)
        up1 = ((w1 * (in_t - cfg.min_level)) >> 14) + cfg.min_level
        up2 = ((w2 * (in_t - cfg.min_level)) >> 14) + cfg.min_level
        up1 = torch.maximum(up1, micv + 2)
        up2 = torch.maximum(up2, micv + 1)
        micv = _w(fire_lo1, up1, _w(fire_lo2, up2, micv))
        in_t = _w(fire_lo, micv, in_t)

        # Branch 5: in range (:850-866).
        go_slow = b5 & (chg_slow > 4000)
        m_inner = _w(go_slow, 1000, m_inner)
        m_outer = _w(go_slow, 500, m_outer)
        up_lim = _w(go_slow, cfg.upper_primary_limit, up_lim)
        lo_lim = _w(go_slow, cfg.lower_primary_limit, lo_lim)
        chg_slow = _w(b5 & ~go_slow, chg_slow + 2, chg_slow)
        micv = _w(b5, in_t, micv)

    # Echo and mute-guard hold (:869-878).
    echo = (echo != 0) if torch.is_tensor(echo) else bool(echo)
    hold = ((mute_guard > 0) & (mute_guard < MUTE_GUARD_MS)) | echo
    mic_vol = _w(hold, torch.minimum(micv, last_mic_vol), micv)
    mic_vol = torch.minimum(torch.clamp(mic_vol, min=cfg.min_output),
                            maxlev)
    out_level = torch.clamp(mic_vol, max=cfg.max_analog)

    new_state = state.replace(
        env_sum=env_sum,
        mic_vol=mic_vol,
        max_level=maxlev,
        last_in_mic_level=in_lvl,
        first_call=torch.ones_like(state.first_call),
        ms_zero=ms_zero,
        ms_too_low=ms_lo,
        ms_too_high=ms_hi,
        change_to_slow_mode=chg_slow,
        msec_inner=m_inner,
        msec_outer=m_outer,
        active_speech=active,
        mute_guard_ms=mute_guard,
        zero_ctrl_max=zc_max,
        vad_threshold=vad_thr,
        upper_limit=up_lim,
        lower_limit=lo_lim,
        rxx160w32=rxx160,
        rxx16_lpw32=rxx16_lp,
        rxx160_lpw32=rxx160_lp,
        rxx16_lpw32_max=rxx_max,
        rxx16_vector=rxx16_vec,
        rxx16_pos=rxx16_pos.to(I32),
    )
    return new_state, out_level, saturation_warning


def analyze(cfg: LegacyAgcConfig, state: AnalogAgcState, bands,
            in_mic_level, echo, gain_table=None):
    """WebRtcAgc_Analyze (analog_agc.cc:903-957).

    bands: (N, num_bands, L) int32 capture bands (after AddMic);
    in_mic_level: (N,) int32; gain_table: None for the config's table, or
    a dynamic (32,) or per-row (N, 32) table (the hybrid AgcManagerDirect
    switches compression gains at run time). Returns (state, gains
    (N, 11), out_mic_level (N,), saturation_warning (N,))."""
    dev = bands.device
    if gain_table is None:
        gain_table = const(_tab(cfg.gain_table), I32, dev)
    dig, gains = digital.compute_digital_gains(
        state.digital, bands[:, 0], cfg.agc_mode, gain_table,
        state.low_level_signal)
    state = state.replace(digital=dig)

    out_level = in_mic_level.to(I32)
    warn = torch.zeros_like(state.low_level_signal)
    if cfg.agc_mode < digital.AGC_MODE_FIXED_DIGITAL:
        analog_state, lvl, w = process_analog(cfg, state, in_mic_level, echo)
        if cfg.agc_mode == digital.AGC_MODE_ADAPTIVE_DIGITAL:
            skip = state.low_level_signal
            state = tree_where(skip, state, analog_state)
            out_level = _w(skip, out_level, lvl)
            warn = torch.where(skip, warn, w)
        else:
            state, out_level, warn = analog_state, lvl, w

    # Queue rotation (:946-955).
    rot = (state.in_queue > 1)[:, None, None]
    env = torch.where(rot, state.env[:, 1:2].expand_as(state.env), state.env)
    rxx = torch.where(rot, state.rxx16w32[:, 1:2].expand_as(state.rxx16w32),
                      state.rxx16w32)
    state = state.replace(env=env, rxx16w32=rxx,
                          in_queue=torch.clamp(state.in_queue - 1, min=0))
    return state, gains, out_level, warn


def process(gains, bands):
    """WebRtcAgc_Process (analog_agc.cc:959-966)."""
    return digital.apply_digital_gains(gains, bands)
