"""Legacy fixed-point int16 resampler (the reference's ``Resampler`` class).

The port's own copy of ``webrtc_audio_processing_tpu/ops/legacy_resampler.py``
(a host module of plain Python integers and numpy there too), bit for bit:
the SPL resampling kernels and the mode state machine of

- common_audio/signal_processing/resample_by_2.c (UpsampleBy2/DownsampleBy2)
- common_audio/signal_processing/resample_by_2_internal.c
  (Up/Down/LPBy2 {Short,Int}To{Short,Int} allpass ladders)
- common_audio/signal_processing/resample_fractional.c (48->32, 32->24,
  44->32 polyphase FIRs)
- common_audio/signal_processing/resample.c (22 kHz family + 32->22)
- common_audio/signal_processing/resample_48khz.c (48<->16, 48<->8 chains)
- common_audio/resampler/resampler.cc (Resampler: mode selection + Push)

with C's int32 wraparound, floor shifts and per-stage truncation. It is a
host utility: the reference uses it outside the APM's hot path (the APM
resamples with the sinc resampler, ``ops/resampler.py``), so no step runs
it and it has no kernel. The sequential allpass recurrences run sample by
sample in Python integers. ``Resampler.push`` takes an int16 numpy array
or a CPU tensor and returns the same kind.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

__all__ = ["Resampler"]

# --------------------------------------------------------------- Q helpers

_M32 = 0xFFFFFFFF


def _w32(x: int) -> int:
    """Wrap a Python int to C int32 (two's complement)."""
    return ((x + 0x80000000) & _M32) - 0x80000000


def _sat16(x: int) -> int:
    return 0x7FFF if x > 0x7FFF else (-0x8000 if x < -0x8000 else x)


def _shr14_round(x: int) -> int:
    return _w32(x + (1 << 13)) >> 14


def _shr14_trunc(x: int) -> int:
    s = x >> 14
    return s + 1 if s < 0 else s


# allpass filter coefficients (resample_by_2_internal.c:21-22).
_AP = ((821, 6110, 12382), (3050, 9368, 15063))
# resample_by_2.c:58-59 (the 1:2 / 2:1 public kernels).
_AP1 = (3284, 24441, 49528)
_AP2 = (12199, 37471, 60255)


def _ap3(tmp0: int, st: list, base: int, coefs) -> int:
    """One 3-section allpass step (the common body in
    resample_by_2_internal.c): state slots st[base..base+3]; returns the
    section-2 output that the callers store/accumulate (st[base+3])."""
    diff = _shr14_round(_w32(tmp0 - st[base + 1]))
    tmp1 = _w32(st[base] + _w32(diff * coefs[0]))
    st[base] = tmp0
    diff = _shr14_trunc(_w32(tmp1 - st[base + 2]))
    tmp0b = _w32(st[base + 1] + _w32(diff * coefs[1]))
    st[base + 1] = tmp1
    diff = _shr14_trunc(_w32(tmp0b - st[base + 3]))
    st[base + 3] = _w32(st[base + 2] + _w32(diff * coefs[2]))
    st[base + 2] = tmp0b
    return st[base + 3]


# ------------------------------------------- resample_by_2_internal kernels


def down_by2_int_to_short(x, state):
    """WebRtcSpl_DownBy2IntToShort (resample_by_2_internal.c:30-116)."""
    n = len(x) >> 1
    low = [0] * n
    up = [0] * n
    for i in range(n):
        low[i] = _ap3(int(x[2 * i]), state, 0, _AP[1]) >> 1
    for i in range(n):
        up[i] = _ap3(int(x[2 * i + 1]), state, 4, _AP[0]) >> 1
    out = np.empty(n, np.int16)
    for i in range(n):
        out[i] = _sat16(_w32(low[i] + up[i]) >> 15)
    return out


def down_by2_short_to_int(x, state):
    """WebRtcSpl_DownBy2ShortToInt (:125-194)."""
    n = len(x) >> 1
    out = np.empty(n, np.int64)
    for i in range(n):
        t = _w32((int(x[2 * i]) << 15) + (1 << 14))
        out[i] = _ap3(t, state, 0, _AP[1]) >> 1
    for i in range(n):
        t = _w32((int(x[2 * i + 1]) << 15) + (1 << 14))
        out[i] = _w32(int(out[i]) + (_ap3(t, state, 4, _AP[0]) >> 1))
    return out


def up_by2_short_to_int(x, state):
    """WebRtcSpl_UpBy2ShortToInt (:201-262)."""
    n = len(x)
    out = np.empty(2 * n, np.int64)
    for i in range(n):
        t = _w32((int(x[i]) << 15) + (1 << 14))
        out[2 * i] = _ap3(t, state, 4, _AP[0]) >> 15
    for i in range(n):
        t = _w32((int(x[i]) << 15) + (1 << 14))
        out[2 * i + 1] = _ap3(t, state, 0, _AP[1]) >> 15
    return out


def up_by2_int_to_int(x, state):
    """WebRtcSpl_UpBy2IntToInt (:269-329)."""
    n = len(x)
    out = np.empty(2 * n, np.int64)
    for i in range(n):
        out[2 * i] = _ap3(int(x[i]), state, 4, _AP[0])
    for i in range(n):
        out[2 * i + 1] = _ap3(int(x[i]), state, 0, _AP[1])
    return out


def up_by2_int_to_short(x, state):
    """WebRtcSpl_UpBy2IntToShort (:336-408)."""
    n = len(x)
    out = np.empty(2 * n, np.int16)
    for i in range(n):
        out[2 * i] = _sat16(_ap3(int(x[i]), state, 4, _AP[0]) >> 15)
    for i in range(n):
        out[2 * i + 1] = _sat16(_ap3(int(x[i]), state, 0, _AP[1]) >> 15)
    return out


def _lp_by2(x, state, short_input: bool):
    """WebRtcSpl_LPBy2{Short,Int}ToInt (:415-545 / :546-676). state: 16."""
    n = len(x) >> 1

    def load(v):
        return _w32((int(v) << 15) + (1 << 14)) if short_input else int(v)

    out = np.empty(2 * n, np.int64)
    # lower allpass: odd input -> even output (one-sample polyphase delay
    # carried in state[12]).
    tmp0 = state[12]
    for i in range(n):
        out[2 * i] = _ap3(tmp0, state, 0, _AP[1]) >> 1
        tmp0 = load(x[2 * i + 1])
    # upper allpass: even input -> even output.
    for i in range(n):
        t = load(x[2 * i])
        out[2 * i] = _w32(int(out[2 * i]) + (_ap3(t, state, 4, _AP[0]) >> 1)) >> 15
    # lower allpass: even input -> odd output.
    for i in range(n):
        t = load(x[2 * i])
        out[2 * i + 1] = _ap3(t, state, 8, _AP[1]) >> 1
    # upper allpass: odd input -> odd output (fills state[12] for the next
    # call's polyphase delay).
    for i in range(n):
        t = load(x[2 * i + 1])
        out[2 * i + 1] = (
            _w32(int(out[2 * i + 1]) + (_ap3(t, state, 12, _AP[0]) >> 1)) >> 15
        )
    return out


def lp_by2_short_to_int(x, state):
    return _lp_by2(x, state, True)


def lp_by2_int_to_int(x, state):
    return _lp_by2(x, state, False)


# --------------------------------------------------- resample_by_2 kernels


def _mul_accum(a: int, b: int, c: int) -> int:
    """WEBRTC_SPL_SCALEDIFF32 (signal_processing_library.h:72-73):
    c + the 32 most significant bits of a * b (a: uint16 coef, b: int32)."""
    return _w32(c + _w32((b >> 16) * a) + ((( b & 0xFFFF) * a) >> 16))


def _ap3_by2(in32: int, st: list, base: int, coefs) -> int:
    diff = _w32(in32 - st[base + 1])
    tmp1 = _mul_accum(coefs[0], diff, st[base])
    st[base] = in32
    diff = _w32(tmp1 - st[base + 2])
    tmp2 = _mul_accum(coefs[1], diff, st[base + 1])
    st[base + 1] = tmp1
    diff = _w32(tmp2 - st[base + 3])
    st[base + 3] = _mul_accum(coefs[2], diff, st[base + 2])
    st[base + 2] = tmp2
    return st[base + 3]


def downsample_by2(x, state):
    """WebRtcSpl_DownsampleBy2 (resample_by_2.c:70-126)."""
    n = len(x) >> 1
    out = np.empty(n, np.int16)
    for i in range(n):
        lo = _ap3_by2(_w32(int(x[2 * i]) << 10), state, 0, _AP2)
        hi = _ap3_by2(_w32(int(x[2 * i + 1]) << 10), state, 4, _AP1)
        out[i] = _sat16(_w32(lo + hi + 1024) >> 11)
    return out


def upsample_by2(x, state):
    """WebRtcSpl_UpsampleBy2 (resample_by_2.c:128-187)."""
    n = len(x)
    out = np.empty(2 * n, np.int16)
    for i in range(n):
        in32 = _w32(int(x[i]) << 10)
        lo = _ap3_by2(in32, state, 0, _AP1)
        out[2 * i] = _sat16(_w32(lo + 512) >> 10)
        hi = _ap3_by2(in32, state, 4, _AP2)
        out[2 * i + 1] = _sat16(_w32(hi + 512) >> 10)
    return out


# ------------------------------------------------ fractional FIR kernels
#
# These polyphase FIRs are pure dataflow (state rides in the leading 8
# input samples) — evaluated vectorized in int64 with a final int32 wrap,
# which reproduces C's wrapping accumulation exactly because the wrap is a
# ring homomorphism (sum mod 2^32 == mod of sum).

_C48TO32 = np.array(
    [[778, -2050, 1087, 23285, 12903, -3783, 441, 222],
     [222, 441, -3783, 12903, 23285, 1087, -2050, 778]], np.int64)

_C32TO24 = np.array(
    [[767, -2362, 2434, 24406, 10620, -3838, 721, 90],
     [386, -381, -2646, 19062, 19062, -2646, -381, 386],
     [90, 721, -3838, 10620, 24406, 2434, -2362, 767]], np.int64)

_C44TO32 = np.array(
    [[117, -669, 2245, -6183, 26267, 13529, -3245, 845, -138],
     [-101, 612, -2283, 8532, 29790, -5138, 1789, -524, 91],
     [50, -292, 1016, -3064, 32010, 3933, -1147, 315, -53],
     [-156, 974, -3863, 18603, 21691, -6246, 2353, -712, 126]], np.int64)

_C32TO22 = np.array(
    [[127, -712, 2359, -6333, 23456, 16775, -3695, 945, -154],
     [-39, 230, -830, 2785, 32366, -2324, 760, -218, 38],
     [117, -663, 2222, -6133, 26634, 13070, -3174, 831, -137],
     [-77, 457, -1677, 5958, 31175, -4136, 1405, -408, 71],
     [98, -560, 1900, -5406, 29240, 9423, -2480, 663, -110]], np.int64)


def _w32v(x):
    return ((x + 0x80000000) & _M32) - 0x80000000


def _blocked(x, k, block, taps):
    """(K, taps) sliding views at offsets block*m for m in range(k)."""
    idx = (np.arange(k)[:, None] * block) + np.arange(taps)[None, :]
    return np.asarray(x, np.int64)[idx]


def resample_48to32(x, k):
    """WebRtcSpl_Resample48khzTo32khz (resample_fractional.c:41-77):
    3 in -> 2 out per block; x: int32[3k + 5]... (first 8 are state)."""
    w = _blocked(x, k, 3, 9)
    out = np.empty(2 * k, np.int64)
    out[0::2] = _w32v((1 << 14) + w[:, :8] @ _C48TO32[0])
    out[1::2] = _w32v((1 << 14) + w[:, 1:9] @ _C48TO32[1])
    return out


def resample_32to24(x, k):
    """WebRtcSpl_Resample32khzTo24khz (:84-130): 4 in -> 3 out per block."""
    w = _blocked(x, k, 4, 10)
    out = np.empty(3 * k, np.int64)
    out[0::3] = _w32v((1 << 14) + w[:, 0:8] @ _C32TO24[0])
    out[1::3] = _w32v((1 << 14) + w[:, 1:9] @ _C32TO24[1])
    out[2::3] = _w32v((1 << 14) + w[:, 2:10] @ _C32TO24[2])
    return out


def resample_44to32(x, k):
    """WebRtcSpl_Resample44khzTo32khz (:190-236): 11 in -> 8 out/block."""
    w = _blocked(x, k, 11, 18)
    out = np.empty(8 * k, np.int64)
    out[0::8] = _w32v((int(1) << 15) * w[:, 3] + (1 << 14))
    out[4::8] = _w32v((1 << 14) + w[:, 5:14] @ _C44TO32[3])
    # ResampDotProduct pairs (forward window, mirrored window).
    out[1::8] = _w32v((1 << 14) + w[:, 0:9] @ _C44TO32[0])
    out[7::8] = _w32v((1 << 14) + w[:, 17:8:-1] @ _C44TO32[0])
    out[2::8] = _w32v((1 << 14) + w[:, 2:11] @ _C44TO32[1])
    out[6::8] = _w32v((1 << 14) + w[:, 15:6:-1] @ _C44TO32[1])
    out[3::8] = _w32v((1 << 14) + w[:, 3:12] @ _C44TO32[2])
    out[5::8] = _w32v((1 << 14) + w[:, 14:5:-1] @ _C44TO32[2])
    return out


def resample_32to22(x, k, to_short: bool):
    """WebRtcSpl_32khzTo22khzIntTo{Int,Short} (resample.c:415-511):
    16 in -> 11 out per block."""
    w = _blocked(x, k, 16, 23)
    out = np.empty(11 * k, np.int64)
    pairs = [  # (out_fwd, in_off, out_rev, rev_start, coef_row)
        (1, 0, 10, 22, 0),
        (2, 2, 9, 20, 1),
        (3, 3, 8, 19, 2),
        (4, 5, 7, 17, 3),
        (5, 6, 6, 16, 4),
    ]
    if to_short:
        first = np.clip(w[:, 3], -0x8000, 0x7FFF)  # In[3] saturated, unshifted
    else:
        out[0::11] = _w32v((int(1) << 15) * w[:, 3] + (1 << 14))
    for fwd, off, rev, rstart, row in pairs:
        out[fwd::11] = _w32v((1 << 14) + w[:, off : off + 9] @ _C32TO22[row])
        out[rev::11] = _w32v(
            (1 << 14) + w[:, rstart : rstart - 9 : -1] @ _C32TO22[row]
        )
    if to_short:
        out = np.clip(out >> 15, -0x8000, 0x7FFF)
        out[0::11] = first
        return out.astype(np.int16)
    return out


# ----------------------------------------------------------- 48 kHz chains


@dataclass
class _ChainState:
    s1: list = field(default_factory=lambda: [0] * 16)
    s2: list = field(default_factory=lambda: [0] * 8)
    s3: list = field(default_factory=lambda: [0] * 8)
    s4: list = field(default_factory=lambda: [0] * 8)


def resample_48to16(x, st: _ChainState):
    """WebRtcSpl_Resample48khzTo16khz (resample_48khz.c:27-51). x: 480."""
    lp = lp_by2_short_to_int(x, st.s1)  # 480 int32
    ext = np.concatenate([np.asarray(st.s2, np.int64), lp])
    st.s2[:] = [int(v) for v in lp[-8:]]
    mid = resample_48to32(ext, 160)  # 320
    return down_by2_int_to_short(mid, st.s3)  # 160


def resample_16to48(x, st: _ChainState):
    """WebRtcSpl_Resample16khzTo48khz (:66-91). x: 160."""
    up = up_by2_short_to_int(x, st.s1)  # 320
    ext = np.concatenate([np.asarray(st.s2, np.int64), up])
    st.s2[:] = [int(v) for v in up[-8:]]
    mid = resample_32to24(ext, 80)  # 240
    return up_by2_int_to_short(mid, st.s3)  # 480


def resample_48to8(x, st: _ChainState):
    """WebRtcSpl_Resample48khzTo8khz (:103-137). x: 480."""
    d = down_by2_short_to_int(x, st.s4)  # 240
    lp = lp_by2_int_to_int(d, st.s1)  # 240
    ext = np.concatenate([np.asarray(st.s2, np.int64), lp])
    st.s2[:] = [int(v) for v in lp[-8:]]
    mid = resample_48to32(ext, 80)  # 160
    return down_by2_int_to_short(mid, st.s3)  # 80


def resample_8to48(x, st: _ChainState):
    """WebRtcSpl_Resample8khzTo48khz (:148-183). x: 80."""
    up = up_by2_short_to_int(x, st.s4)  # 160
    ext = np.concatenate([np.asarray(st.s2, np.int64), up])
    st.s2[:] = [int(v) for v in up[-8:]]
    mid = resample_32to24(ext, 40)  # 120
    up2 = up_by2_int_to_int(mid, st.s1)  # 240 (S_12_24: slots 0..7)
    return up_by2_int_to_short(up2, st.s3)  # 480


# ----------------------------------------------------------- 22 kHz family


def resample_22to16(x, st: _ChainState):
    """WebRtcSpl_Resample22khzTo16khz (resample.c:43-94). x: 220."""
    out = np.empty(160, np.int16)
    for k in range(5):  # SUB_BLOCKS_22_16
        seg = x[44 * k : 44 * (k + 1)]
        up = up_by2_short_to_int(seg, st.s1)  # 88
        ext = np.concatenate([np.asarray(st.s2, np.int64), up])
        st.s2[:] = [int(v) for v in up[-8:]]
        mid = resample_44to32(ext, 8)  # 64
        out[32 * k : 32 * (k + 1)] = down_by2_int_to_short(mid, st.s3)
    return out


def resample_16to22(x, st: _ChainState):
    """WebRtcSpl_Resample16khzTo22khz (resample.c:116-163). x: 160."""
    out = np.empty(220, np.int16)
    for k in range(4):  # SUB_BLOCKS_16_22
        seg = x[40 * k : 40 * (k + 1)]
        up = up_by2_short_to_int(seg, st.s1)  # 80
        ext = np.concatenate([np.asarray(st.s2, np.int64), up])
        st.s2[:] = [int(v) for v in up[-8:]]
        out[55 * k : 55 * (k + 1)] = resample_32to22(ext, 5, True)
    return out


def resample_22to8(x, st: _ChainState):
    """WebRtcSpl_Resample22khzTo8khz (resample.c:176-226). x: 220."""
    out = np.empty(80, np.int16)
    for k in range(2):  # SUB_BLOCKS_22_8
        seg = x[110 * k : 110 * (k + 1)]
        lp = lp_by2_short_to_int(seg, st.s1)  # 110
        ext = np.concatenate([np.asarray(st.s2, np.int64), lp])
        st.s2[:] = [int(v) for v in lp[-8:]]
        mid = resample_44to32(ext, 10)  # 80
        out[40 * k : 40 * (k + 1)] = down_by2_int_to_short(mid, st.s3)
    return out


def resample_8to22(x, st: _ChainState):
    """WebRtcSpl_Resample8khzTo22khz (resample.c:246-299). x: 80."""
    out = np.empty(220, np.int16)
    for k in range(2):  # SUB_BLOCKS_8_22
        seg = x[40 * k : 40 * (k + 1)]
        up = up_by2_short_to_int(seg, st.s1)  # 80
        ext = np.concatenate([np.asarray(st.s2, np.int64), up])
        st.s2[:] = [int(v) for v in up[-8:]]
        mid = resample_32to22(ext, 5, False)  # 55
        out[110 * k : 110 * (k + 1)] = up_by2_int_to_short(mid, st.s3)
    return out


# --------------------------------------------------------------- Resampler


class Resampler:
    """resampler.cc Resampler: int16 Push API over the mode state machine.

    All methods mirror the reference: return 0 on success, -1 on failure.
    """

    # (reduced_in, reduced_out) -> mode key (resampler.cc:313-407)
    _MODES = {
        (1, 1): "1:1", (1, 2): "1:2", (1, 3): "1:3", (1, 4): "1:4",
        (1, 6): "1:6", (1, 12): "1:12", (2, 3): "2:3", (2, 11): "2:11",
        (4, 11): "4:11", (8, 11): "8:11", (3, 2): "3:2", (11, 2): "11:2",
        (11, 4): "11:4", (11, 16): "11:16", (11, 32): "11:32",
        (11, 8): "11:8", (2, 1): "2:1", (3, 1): "3:1", (4, 1): "4:1",
        (6, 1): "6:1", (12, 1): "12:1",
    }

    def __init__(self, in_freq=None, out_freq=None, num_channels=None):
        self._mode = None
        self._in_khz = 0
        self._out_khz = 0
        self._channels = 0
        self._left = self._right = None
        if in_freq is not None:
            self.reset(in_freq, out_freq, num_channels)

    @staticmethod
    def _compute_mode(in_freq, out_freq):
        import math

        g = math.gcd(in_freq, out_freq)
        return Resampler._MODES.get((in_freq // g, out_freq // g))

    def reset_if_needed(self, in_freq, out_freq, num_channels):
        if (in_freq // 1000 != self._in_khz
                or out_freq // 1000 != self._out_khz
                or num_channels != self._channels):
            return self.reset(in_freq, out_freq, num_channels)
        return 0

    def reset(self, in_freq, out_freq, num_channels):
        if num_channels not in (1, 2):
            return -1
        mode = self._compute_mode(in_freq, out_freq)
        if mode is None:
            return -1
        self._mode = mode
        self._in_khz = in_freq // 1000
        self._out_khz = out_freq // 1000
        self._channels = num_channels
        if num_channels == 2:
            self._left = Resampler(in_freq, out_freq, 1)
            self._right = Resampler(in_freq, out_freq, 1)
            return 0
        # Per-stage states, mirroring the malloc'd state1_/2_/3_.
        self._s1 = [0] * 8
        self._s2 = [0] * 8
        self._s3 = [0] * 8
        self._c1 = _ChainState()
        self._c2 = _ChainState()
        self._c3 = _ChainState()
        return 0

    def push(self, samples):
        """Resample int16 samples (a numpy array or a CPU tensor). Returns
        (0, out) with out of the input's kind, or (-1, None). Stereo input
        and output are interleaved, as in the reference."""
        if torch.is_tensor(samples):
            rc, out = self._push(samples.numpy())
            return rc, None if out is None else torch.from_numpy(out)
        return self._push(samples)

    def _push(self, samples):
        x = np.asarray(samples, np.int16)
        if self._channels == 2:
            out_l = self._left._push(x[0::2])
            out_r = self._right._push(x[1::2])
            if out_l[0] or out_r[0] or len(out_l[1]) != len(out_r[1]):
                return -1, None
            out = np.empty(2 * len(out_l[1]), np.int16)
            out[0::2] = out_l[1]
            out[1::2] = out_r[1]
            return 0, out

        m = self._mode
        n = len(x)
        if m == "1:1":
            return 0, x.copy()
        if m == "1:2":
            return 0, upsample_by2(x, self._s1)
        if m == "2:1":
            return 0, downsample_by2(x, self._s1)
        if m == "1:4":
            t = upsample_by2(x, self._s1)
            return 0, upsample_by2(t, self._s2)
        if m == "4:1":
            t = downsample_by2(x, self._s1)
            return 0, downsample_by2(t, self._s2)
        if m == "1:3":
            if n % 160:
                return -1, None
            return 0, self._blocks(x, 160, resample_16to48, self._c1, 480)
        if m == "3:1":
            if n % 480:
                return -1, None
            return 0, self._blocks(x, 480, resample_48to16, self._c1, 160)
        if m == "1:6":
            if n % 80:
                return -1, None
            t = upsample_by2(x, self._s1)
            return 0, self._blocks(t, 160, resample_16to48, self._c1, 480)
        if m == "6:1":
            if n % 480:
                return -1, None
            t = self._blocks(x, 480, resample_48to16, self._c1, 160)
            return 0, downsample_by2(t, self._s2)
        if m == "1:12":
            if n % 40:
                return -1, None
            t = upsample_by2(x, self._s1)
            t = upsample_by2(t, self._s2)
            return 0, self._blocks(t, 160, resample_16to48, self._c1, 480)
        if m == "12:1":
            if n % 480:
                return -1, None
            t = self._blocks(x, 480, resample_48to16, self._c1, 160)
            t = downsample_by2(t, self._s2)
            return 0, downsample_by2(t, self._s3)
        if m == "2:3":
            if n % 160:
                return -1, None
            t = self._blocks(x, 160, resample_16to48, self._c1, 480)
            return 0, downsample_by2(t, self._s2)
        if m == "3:2":
            t = upsample_by2(x, self._s1)
            if len(t) % 480:
                return -1, None
            return 0, self._blocks(t, 480, resample_48to16, self._c1, 160)
        if m == "2:11":
            if n % 80:
                return -1, None
            t = upsample_by2(x, self._s1)
            return 0, self._blocks(t, 80, resample_8to22, self._c1, 220)
        if m == "4:11":
            if n % 80:
                return -1, None
            return 0, self._blocks(x, 80, resample_8to22, self._c1, 220)
        if m == "8:11":
            if n % 160:
                return -1, None
            return 0, self._blocks(x, 160, resample_16to22, self._c1, 220)
        if m == "11:16":
            if n % 110:
                return -1, None
            t = upsample_by2(x, self._s1)
            return 0, self._blocks(t, 220, resample_22to16, self._c1, 160)
        if m == "11:32":
            if n % 110:
                return -1, None
            t = upsample_by2(x, self._s1)
            t = self._blocks(t, 220, resample_22to16, self._c1, 160)
            return 0, upsample_by2(t, self._s3)
        if m == "11:2":
            if n % 220:
                return -1, None
            t = self._blocks(x, 220, resample_22to8, self._c1, 80)
            return 0, downsample_by2(t, self._s2)
        if m == "11:4":
            if n % 220:
                return -1, None
            return 0, self._blocks(x, 220, resample_22to8, self._c1, 80)
        if m == "11:8":
            if n % 220:
                return -1, None
            return 0, self._blocks(x, 220, resample_22to16, self._c1, 160)
        return -1, None

    @staticmethod
    def _blocks(x, in_block, fn, st, out_block):
        nb = len(x) // in_block
        out = np.empty(nb * out_block, np.int16)
        for b in range(nb):
            out[b * out_block : (b + 1) * out_block] = fn(
                x[b * in_block : (b + 1) * in_block], st
            )
        return out
