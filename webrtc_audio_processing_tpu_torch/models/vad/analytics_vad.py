"""The analytics (pitch-based) VAD chain: VadAudioProc, PitchBasedVad and
StandaloneVad, composed by VoiceActivityDetector.

Port of ``webrtc_audio_processing_tpu/models/vad/analytics_vad.py``
(reference: modules/audio_processing/vad/{voice_activity_detector,
vad_audio_proc, pitch_based_vad, pitch_internal, pole_zero_filter,
standalone_vad, vad_circular_buffer, gmm}.cc and the iSAC pitch DSP of
modules/audio_coding/codecs/isac/main/source/{isac_vad, filter_functions,
pitch_estimator, pitch_filter}.c), in float32 as the JAX package runs it,
on (N, ...) rows.

The float linear IIRs with one of K1's forms run on K1
(``ops/cuda_biquad.py``), the streams as its lanes:
- the first-order all-pass sections (the pre-filter bank, the pitch
  decimator): K1's all-pass form; a section's state s = x[-1] - a y[-1]
  enters as (x1 = s, y1 = 0) and leaves as x1 - a y1;
- the second-order sections, as DF1 biquads: the pre-filter bank's input
  HPF (direct form II) as its all-pole half on K1, its zeros as a
  two-tap FIR on the pole half's output; the decimated signal's
  all-pole low-pass; the pitch analysis's HPF (transposed direct form II)
  with its state mapped to and from a DF1 history; the VadAudioProc's
  pole-zero HPF, DF1 already.
The form changes the rounding order, so against the JAX package these
hold to a float tolerance (tests/test_torch_vad.py). The 6th-order LPC
all-pole of the weighting filter, whose coefficients differ per stream,
is a loop over its 60 samples.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from webrtc_audio_processing_tpu_torch.models.vad import legacy_vad
from webrtc_audio_processing_tpu_torch.ops import cuda_biquad
from webrtc_audio_processing_tpu_torch.ops.batch import const, tree_where

F32 = torch.float32
I32 = torch.int32

# ------------------------------------------------------------ constants

FRAMESAMPLES = 480
FRAMESAMPLES_HALF = 240
QLOOKAHEAD = 24
PITCH_FRAME_LEN = 240
PITCH_MAX_LAG = 140
PITCH_MIN_LAG = 20
PITCH_LAG_SPAN2 = PITCH_MAX_LAG // 2 - PITCH_MIN_LAG // 2 + 5  # 65
PITCH_CORR_LEN2 = 60
PITCH_CORR_STEP2 = PITCH_FRAME_LEN // 4  # 60
PITCH_SUBFRAMES = 4
PITCH_SUBFRAME_LEN = 60
PITCH_GRAN_PER_SUBFRAME = 5
PITCH_UPDATE = 12
PITCH_WLPCORDER = 6
PITCH_WLPCWINLEN = 240
PITCH_WLPCBUFLEN = 240
PITCH_WLPCASYM = 0.3
PITCH_BUFFSIZE = PITCH_MAX_LAG + 50  # 190
PITCH_INTBUFFSIZE = PITCH_FRAME_LEN + PITCH_BUFFSIZE
PITCH_UPSTEP = 1.5
PITCH_DOWNSTEP = 0.67
PITCH_DAMPORDER = 5
PITCH_FILTDELAY = 1.5
PITCH_FRACS = 8
PITCH_FRACORDER = 9
PITCH_BW = 11
PITCH_MAX_NUM_PEAKS = 10
PITCH_PEAK_DECAY = 0.85
PITCH_MAX_GAIN = 0.45
PITCH_MAX_GAIN_06 = 0.27
ALLPASSSECTIONS = 2
W_SURF = PITCH_LAG_SPAN2 + 4  # surface row stride
DEC_KEEP = (PITCH_CORR_LEN2 + PITCH_CORR_STEP2 + PITCH_MAX_LAG // 2
            - PITCH_FRAME_LEN // 2 + 2)  # 72
DEC_TOTAL = PITCH_CORR_LEN2 + PITCH_CORR_STEP2 + PITCH_MAX_LAG // 2 + 2

UPPER_AP = np.array([0.0347, 0.3826], np.float32)
LOWER_AP = np.array([0.1544, 0.744], np.float32)
COMPOSITE_AP = np.array([0.0347, 0.1544, 0.3826, 0.744], np.float32)
TRANSFORM1 = np.array([
    -0.00158678506084, 0.00127157815343, -0.00104805672709, 0.00084837248079,
    0.00134467983258, -0.00107756549387, 0.00088814793277, -0.00071893072525,
], np.float32).reshape(2, 4)
TRANSFORM2 = np.array([
    -0.00170686041697, 0.00136780109829, -0.00112736532350, 0.00091257055385,
    0.00103094281812, -0.00082615076557, 0.00068092756088, -0.00055119165484,
], np.float32).reshape(2, 4)
HP_IN_COEF = np.array([-1.94895953203325, 0.94984516000000,
                       -0.05101826139794, 0.05015484000000], np.float32)
DAMP_FILTER = np.array([-0.07, 0.25, 0.64, 0.25, -0.07], np.float32)
INTERPOL_WIN = np.array([
    -0.00067556028640, 0.02184247643159, -0.12203175715679, 0.60086484101160,
    0.60086484101160, -0.12203175715679, 0.02184247643159, -0.00067556028640,
], np.float32)
INTRP_COEF = np.array([
    [-0.02239172458614, 0.06653315052934, -0.16515880017569, 0.60701333734125,
     0.64671399919202, -0.20249000396417, 0.09926548334755, -0.04765933793109,
     0.01754159521746],
    [-0.01985640750434, 0.05816126837866, -0.13991265473714, 0.44560418147643,
     0.79117042386876, -0.20266133815188, 0.09585268418555, -0.04533310458084,
     0.01654127246314],
    [-0.01463300534216, 0.04229888475060, -0.09897034715253, 0.28284326017787,
     0.90385267956632, -0.16976950138649, 0.07704272393639, -0.03584218578311,
     0.01295781500709],
    [-0.00764851320885, 0.02184035544377, -0.04985561057281, 0.13083306574393,
     0.97545011664662, -0.10177807997561, 0.04400901776474, -0.02010737175166,
     0.00719783432422],
    [0.0, 0.0, -1e-14, 1e-14, 0.99999999999999, 1e-14, -1e-14, 0.0, 0.0],
    [0.00719783432422, -0.02010737175166, 0.04400901776474,
     -0.10177807997562, 0.97545011664663, 0.13083306574393,
     -0.04985561057280, 0.02184035544377, -0.00764851320885],
    [0.01295781500710, -0.03584218578312, 0.07704272393640,
     -0.16976950138650, 0.90385267956634, 0.28284326017785,
     -0.09897034715252, 0.04229888475059, -0.01463300534216],
    [0.01654127246315, -0.04533310458085, 0.09585268418557,
     -0.20266133815190, 0.79117042386878, 0.44560418147640,
     -0.13991265473712, 0.05816126837865, -0.01985640750433],
], np.float32)
GAIN_WEIGHT = np.array([
    [0.29714285714286, -0.30857142857143, -0.05714285714286,
     0.05142857142857, 0.01714285714286],
    [-0.30857142857143, 0.67428571428571, -0.27142857142857,
     -0.14571428571429, 0.05142857142857],
    [-0.05714285714286, -0.27142857142857, 0.65714285714286,
     -0.27142857142857, -0.05714285714286],
    [0.05142857142857, -0.14571428571429, -0.27142857142857,
     0.67428571428571, -0.30857142857143],
    [0.01714285714286, 0.05142857142857, -0.05714285714286,
     -0.30857142857143, 0.29714285714286],
], np.float32)

# VadAudioProc constants (vad_audio_proc.h:38-69).
SAMPLE_RATE_HZ = 16000
LENGTH_10MS = 160
NUM_PAST_SIGNAL_SAMPLES = 80
NUM_SUBFRAME_SAMPLES = 160
NUM_10MS_SUBFRAMES = 3
BUFFER_LENGTH = NUM_PAST_SIGNAL_SAMPLES + 3 * NUM_SUBFRAME_SAMPLES  # 560
DFT_SIZE = 512
LPC_ORDER = 16
SILENCE_RMS = 5.0
FREQ_RESOLUTION = SAMPLE_RATE_HZ / float(DFT_SIZE)

HPF_NUMERATOR = np.array([0.974827, -1.949650, 0.974827], np.float32)
HPF_DENOMINATOR = np.array([1.0, -1.971999, 0.972457], np.float32)

CORR_WEIGHT = np.array([
    1.000000, 0.985000, 0.970225, 0.955672, 0.941337, 0.927217, 0.913308,
    0.899609, 0.886115, 0.872823, 0.859730, 0.846834, 0.834132, 0.821620,
    0.809296, 0.797156, 0.785199], np.float32)


def _lpc_anal_win() -> np.ndarray:
    # kLpcAnalWin (vad_audio_proc_internal.h): sin(pi*k/239), k = 0..239.
    return np.sin(np.pi * np.arange(240) / 239.0)


def _c(arr: np.ndarray, dev, dtype=F32) -> torch.Tensor:
    """A numpy constant on ``dev`` (float32 unless ``dtype`` says
    otherwise) through ``ops.batch.const``: copied to the device once, so
    no host-to-device copy on the step, none in a graph capture."""
    flat = np.asarray(arr, np.float32 if dtype == F32 else None).ravel()
    return const(tuple(flat.tolist()), dtype, dev).reshape(arr.shape)


class _State:
    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------- K1 helpers


def _k1(rows: np.ndarray, st4: torch.Tensor, x: torch.Tensor,
        allpass: bool = False):
    """K1 over the rows of ``x`` (N, T): ``rows`` (K, 5), ``st4`` the
    (4K, N) DF1 state [x1, x2, y1, y2] per section. Returns (st4, y)."""
    coeffs = _c(rows, x.device)
    st4, y_t = cuda_biquad.cascade(coeffs, st4.contiguous(),
                                   x.t().contiguous(), allpass=allpass)
    return st4, y_t.t()


def _allpass_rows(factors) -> np.ndarray:
    a = np.asarray(factors, np.float32)
    return np.stack([a, np.ones_like(a), np.zeros_like(a), a,
                     np.zeros_like(a)], axis=1)


def _ap_state_in(s: torch.Tensor) -> torch.Tensor:
    """All-pass states s (N, K) -> K1 rows (4K, N): x1 = s, the rest 0."""
    N, K = s.shape
    st = s.new_zeros((K, 4, N))
    st[:, 0] = s.t()
    return st.reshape(4 * K, N)


def _ap_state_out(st4: torch.Tensor, factors) -> torch.Tensor:
    """K1 rows -> all-pass states s = x1 - a y1, (N, K)."""
    K = len(factors)
    st = st4.reshape(K, 4, -1)
    a = _c(factors, st4.device)[:, None]
    return (st[:, 0] - a * st[:, 2]).t()


def _allpass_cascade(x, factors, state):
    """WebRtcIsac_AllPassFilter2Float (isac_vad.c:161-176) on K1: x (N, T),
    state (N, K). Returns (y, state)."""
    st4, y = _k1(_ROWS[id(factors)], _ap_state_in(state), x, allpass=True)
    return y, _ap_state_out(st4, factors)


def _all_pole_rows(c0: float, c1: float) -> np.ndarray:
    return np.array([[1.0, 0.0, 0.0, c0, c1]], np.float32)


_ROWS = {id(f): _allpass_rows(f) for f in (COMPOSITE_AP, UPPER_AP,
                                           LOWER_AP)}
# The input HPF's poles (isac_vad.c), the decimated signal's low-pass
# (pitch_estimator.c:214-222).
_HP_IN_POLES = _all_pole_rows(float(HP_IN_COEF[0]), float(HP_IN_COEF[1]))
_DEC_LOWPASS = _all_pole_rows(-0.75, 0.25)


def _all_pole2(x, rows: np.ndarray, y1, y2):
    """y_n = x_n - c0 y_{n-1} - c1 y_{n-2} on K1 (a DF1 biquad with no
    zeros, ``rows`` [[1, 0, 0, c0, c1]]). Returns y (N, T)."""
    st = torch.stack([torch.zeros_like(y1), torch.zeros_like(y1), y1, y2])
    _, y = _k1(rows, st, x)
    return y


def _autocorr(x, order):
    """WebRtcIsac_AutoCorr: r[lag] = sum x[n] x[n + lag]."""
    n = x.shape[-1]
    return torch.stack([torch.sum(x[..., :n - lag] * x[..., lag:], -1)
                        for lag in range(order + 1)], -1)


def _lev_durb(r, order):
    """WebRtcIsac_LevDurb (isac_vad.c:110-139). r: (..., order + 1)."""
    eps = 1e-10
    bad = r[..., 0] < eps
    r = torch.where(bad[..., None], torch.ones_like(r), r)
    a = [torch.ones_like(r[..., 0])] + [torch.zeros_like(r[..., 0])
                                        for _ in range(order)]
    a[1] = -r[..., 1] / r[..., 0]
    alpha = r[..., 0] + r[..., 1] * a[1]
    for m in range(1, order):
        s = r[..., m + 1]
        for i in range(m):
            s = s + a[i + 1] * r[..., m - i]
        km = -s / alpha
        alpha = alpha + km * s
        for i in range((m + 1) >> 1):
            tmp = a[i + 1] + km * a[m - i]
            a[m - i] = a[m - i] + km * a[i + 1]
            a[i + 1] = tmp
        a[m + 1] = km
    poly = torch.stack(a, -1)
    zero_poly = torch.zeros_like(poly)
    zero_poly[..., 0] = 1.0
    return torch.where(bad[..., None], zero_poly, poly)


def _windows(x, width: int, count: int):
    """x (..., L) -> (..., count, width): windows starting at 0..count-1."""
    return x.unfold(-1, width, 1)[..., :count, :]


def _gather_rows(x, start, width: int):
    """x[n, start[n] : start[n] + width] for x (N, L), start (N,) int, with
    ``lax.dynamic_slice``'s clamp of the start."""
    s = torch.clamp(start.long(), 0, x.shape[-1] - width)
    idx = s[:, None] + torch.arange(width, device=x.device)
    return torch.gather(x, 1, idx)


# -------------------------------------------------- iSAC pre-filter bank


@dataclass
class PreFiltBankState(_State):
    inlabuf1: torch.Tensor  # (N, 24)
    inlabuf2: torch.Tensor
    instat1: torch.Tensor  # (N, 4), only [:2] used
    instat2: torch.Tensor
    instat_la1: torch.Tensor
    instat_la2: torch.Tensor
    hp_states: torch.Tensor  # (N, 2)


def _zeros(batch, n, device):
    return torch.zeros((batch, n), dtype=F32, device=device)


def init_prefilt(batch: int, device) -> PreFiltBankState:
    z = lambda n: _zeros(batch, n, device)  # noqa: E731
    return PreFiltBankState(z(QLOOKAHEAD), z(QLOOKAHEAD), z(4), z(4), z(4),
                            z(4), z(2))


def split_and_filter(state: PreFiltBankState, pin):
    """WebRtcIsac_SplitAndFilterFloat (isac_vad.c:210-409).

    pin: (N, 480). Returns (state, lp, hp, lp_la, hp_la), each (N, 240)."""
    N = pin.shape[0]
    dev = pin.device
    # The input HPF (direct form II): its poles on K1, its zeros as a FIR
    # over the pole half's output.
    w1, w2 = state.hp_states[:, 0], state.hp_states[:, 1]
    w = _all_pole2(pin, _HP_IN_POLES, w1, w2)
    wpad = torch.cat([w2[:, None], w1[:, None], w], 1)
    inp = pin + HP_IN_COEF[2] * wpad[:, 1:-1] + HP_IN_COEF[3] * wpad[:, :-2]
    hp_st = torch.stack([w[:, -1], w[:, -2]], 1)

    # Both backward channels at once: lanes [channel 0 rows, channel 1].
    k = torch.arange(FRAMESAMPLES_HALF, device=dev)
    kl = torch.arange(QLOOKAHEAD, device=dev)
    vec = torch.cat([inp[:, FRAMESAMPLES - 1 - 2 * k],
                     inp[:, FRAMESAMPLES - 2 - 2 * k]], 0)
    rows = _ROWS[id(COMPOSITE_AP)]
    st4, out = _k1(rows, vec.new_zeros((16, 2 * N)), vec, allpass=True)
    main = out.flip(1)
    fors = _ap_state_out(st4, COMPOSITE_AP)  # (2N, 4)
    _, la = _k1(rows, st4, torch.cat([state.inlabuf1, state.inlabuf2], 0),
                allpass=True)
    tempin = torch.cat([la.flip(1), main], 1)
    t1, t2 = tempin[:N], tempin[N:]
    new_la1 = inp[:, FRAMESAMPLES - 1 - 2 * kl]
    new_la2 = inp[:, FRAMESAMPLES - 2 - 2 * kl]

    instat1 = state.instat1.clone()
    instat2 = state.instat2.clone()
    instat1[:, :2] += fors[:N] @ _c(TRANSFORM1, dev).t()
    instat2[:, :2] += fors[N:] @ _c(TRANSFORM2, dev).t()

    # The upper and lower all-pass branches of the main and the lookahead
    # signals: one K1 call per branch, the two signals side by side.
    o1l1, up_st = _allpass_cascade(
        torch.cat([t1[:, :FRAMESAMPLES_HALF], inp[:, 1::2]], 0), UPPER_AP,
        torch.cat([instat1[:, :2], state.instat_la1[:, :2]], 0))
    o2l2, lo_st = _allpass_cascade(
        torch.cat([t2[:, :FRAMESAMPLES_HALF], inp[:, 0::2]], 0), LOWER_AP,
        torch.cat([instat2[:, :2], state.instat_la2[:, :2]], 0))
    o1, l1 = o1l1[:N], o1l1[N:]
    o2, l2 = o2l2[:N], o2l2[N:]
    lp = 0.5 * (o1 + o2)
    hp = 0.5 * (o1 - o2)
    lp_la = 0.5 * (l1 + l2)
    hp_la = 0.5 * (l1 - l2)

    instat1[:, :2] = up_st[:N]
    instat2[:, :2] = lo_st[:N]
    instat_la1 = state.instat_la1.clone()
    instat_la2 = state.instat_la2.clone()
    instat_la1[:, :2] = up_st[N:]
    instat_la2[:, :2] = lo_st[N:]
    state = state.replace(inlabuf1=new_la1, inlabuf2=new_la2,
                          instat1=instat1, instat2=instat2,
                          instat_la1=instat_la1, instat_la2=instat_la2,
                          hp_states=hp_st)
    return state, lp, hp, lp_la, hp_la


# ---------------------------------------------------- weighting filter


@dataclass
class WeightFiltState(_State):
    buffer: torch.Tensor  # (N, 240)
    weo_state: torch.Tensor  # (N, 6) [y-1 .. y-6]
    who_state: torch.Tensor  # (N, 6), unused by the identity pole section


def _weight_window() -> np.ndarray:
    t = 0.5 + np.arange(PITCH_WLPCWINLEN)
    denum = 1.0 / PITCH_WLPCWINLEN
    d = (PITCH_WLPCASYM * t * denum
         + (1 - PITCH_WLPCASYM) * t * t * denum * denum) * 3.14159265
    return (np.sin(d) ** 2).astype(np.float32)


WEIGHT_WINDOW = _weight_window()
_APOL_DECAY = (0.9 ** np.arange(PITCH_WLPCORDER + 1)).astype(np.float32)


def init_weight_filt(batch: int, device) -> WeightFiltState:
    return WeightFiltState(_zeros(batch, 240, device),
                           _zeros(batch, 6, device),
                           _zeros(batch, 6, device))


def weighting_filter(state: WeightFiltState, x):
    """WebRtcIsac_WeightingFilter (filter_functions.c:118-180).

    x: (N, 240). Returns (state, weighted (N, 240), whitened (N, 240))."""
    dev = x.device
    tmp = torch.cat([state.buffer, x], 1)  # (N, 480)
    win = _c(WEIGHT_WINDOW, dev)
    decay = _c(_APOL_DECAY, dev)
    weout, whout = [], []
    hist = state.weo_state  # [y-1, ..., y-6]
    for n in range(PITCH_SUBFRAMES):
        endpos = PITCH_WLPCBUFLEN + (n + 1) * PITCH_SUBFRAME_LEN
        ext = win * tmp[:, endpos - PITCH_WLPCWINLEN:endpos]
        corr = _autocorr(ext, PITCH_WLPCORDER)
        corr = torch.cat([1.01 * corr[:, :1] + 1.0, corr[:, 1:]], 1)
        apol = _lev_durb(corr, PITCH_WLPCORDER)
        apolr = apol * decay

        base = PITCH_WLPCBUFLEN + n * PITCH_SUBFRAME_LEN
        seg_ext = tmp[:, base - PITCH_WLPCORDER:base + PITCH_SUBFRAME_LEN]
        # All-zero sections: coefficient k multiplies In[-k].
        zflip = _windows(seg_ext, PITCH_WLPCORDER + 1,
                         PITCH_SUBFRAME_LEN).flip(-1)  # (N, 60, 7)
        we_zero = torch.einsum("ntk,nk->nt", zflip, apol)
        whout.append(torch.einsum("ntk,nk->nt", zflip, apolr))

        # All-pole with apolr on we_zero, sample by sample.
        ar = apolr[:, 1:]
        seg = []
        for t in range(PITCH_SUBFRAME_LEN):
            y = we_zero[:, t] - torch.sum(ar * hist, 1)
            hist = torch.cat([y[:, None], hist[:, :-1]], 1)
            seg.append(y)
        weout.append(torch.stack(seg, 1))
    state = state.replace(buffer=tmp[:, PITCH_FRAME_LEN:], weo_state=hist)
    return state, torch.cat(weout, 1), torch.cat(whout, 1)


# --------------------------------------------------------- pitch filters


@dataclass
class PitchFiltState(_State):
    ubuf: torch.Tensor  # (N, 190)
    ystate: torch.Tensor  # (N, 5) [u_{n-1} .. u_{n-5}]
    oldlag: torch.Tensor  # (N,)
    oldgain: torch.Tensor  # (N,)


def init_pitch_filt(batch: int, device) -> PitchFiltState:
    return PitchFiltState(
        ubuf=_zeros(batch, PITCH_BUFFSIZE, device),
        ystate=_zeros(batch, PITCH_DAMPORDER, device),
        oldlag=torch.full((batch,), 50.0, dtype=F32, device=device),
        oldgain=torch.zeros(batch, dtype=F32, device=device),
    )


_DG_PAD = 160  # covers the lag reads below index 0
_DAMP_R = DAMP_FILTER[::-1].copy()


def _filter_granule(in_data, buf, out_dg_pad, damper, damper_dg, coeffs,
                    gain, lag_offset, index: int, num_samples: int,
                    mode: str, sub_frame: int, gain_mult):
    """FilterSegment (pitch_filter.c:128-215), one granule vectorized: the
    fractional-lag reads all precede the granule's writes (lag_offset >=
    25 > FRACORDER + num_samples). Returns (buf, out_seg (N, num), out_dg_pad,
    damper, damper_dg)."""
    dev = in_data.device
    nsl = num_samples + PITCH_FRACORDER - 1
    pos = index + PITCH_BUFFSIZE
    sl = _gather_rows(buf, pos - lag_offset, nsl)
    sw = _windows(sl, PITCH_FRACORDER, num_samples)  # (N, num, 9)
    s = torch.einsum("ntm,nm->nt", sw, coeffs)
    u = gain[:, None] * s
    u_ext = torch.cat([damper[:, :4].flip(1), u], 1)
    uw = _windows(u_ext, PITCH_DAMPORDER, num_samples)  # (N, num, 5)
    damp_r = _c(_DAMP_R, dev)

    if mode == "pre_gain":
        lag_index = index - lag_offset
        s_idx = torch.clamp(lag_index.long() + _DG_PAD, 0,
                            out_dg_pad.shape[-1] - nsl)
        idx = (s_idx[:, None] + torch.arange(nsl, device=dev))[:, None, :]
        dsl = torch.gather(out_dg_pad, 2, idx.expand(-1, 4, -1))
        s2 = torch.einsum("njtm,nm->njt",
                          _windows(dsl, PITCH_FRACORDER, num_samples),
                          coeffs)
        gm = torch.stack(gain_mult, 1)  # (N, 4)
        u_dg = gm[:, :, None] * s[:, None, :] + gain[:, None, None] * s2
        u_dg_ext = torch.cat([damper_dg[:, :, :4].flip(2), u_dg], 2)
        out_dg_seg = -torch.einsum(
            "njtm,m->njt", _windows(u_dg_ext, PITCH_DAMPORDER, num_samples),
            damp_r)
        active = (torch.arange(4, device=dev) <= sub_frame)[None, :, None]
        out_dg_seg = torch.where(active, out_dg_seg, 0.0)
        out_dg_pad = out_dg_pad.clone()
        out_dg_pad[:, :, index + _DG_PAD:index + _DG_PAD + num_samples] = (
            out_dg_seg)
        damper_dg = torch.where(active,
                                u_dg_ext[:, :, -PITCH_DAMPORDER:].flip(2),
                                0.0)

    sumd = torch.einsum("ntm,m->nt", uw, damp_r)
    x_seg = in_data[:, index:index + num_samples]
    out_seg = x_seg - sumd
    buf = buf.clone()
    buf[:, pos:pos + num_samples] = x_seg + out_seg
    damper = u_ext[:, -PITCH_DAMPORDER:].flip(1)
    return buf, out_seg, out_dg_pad, damper, damper_dg


def pitch_filter_frame(in_data, pf: PitchFiltState, lags, gains, mode: str):
    """FilterFrame (pitch_filter.c:244-344) in the pre, pre_la and
    pre_gain modes.

    in_data: (N, 264) (the pre mode reads the first 240). Returns (new_pf,
    out (N, 264), out_dg (N, 4, 264))."""
    N = in_data.shape[0]
    dev = in_data.device
    total = PITCH_FRAME_LEN + QLOOKAHEAD
    buf = torch.cat([pf.ubuf, in_data.new_zeros((N, total))], 1)
    damper = pf.ystate
    outs = []
    out_dg_pad = in_data.new_zeros((N, 4, total + _DG_PAD))
    damper_dg = in_data.new_zeros((N, 4, PITCH_DAMPORDER))
    zero = in_data.new_zeros(N)
    gain_mult = [zero, zero, zero, zero]
    intrp = _c(INTRP_COEF, dev)

    old_lag, old_gain = pf.oldlag, pf.oldgain
    jump = (lags[:, 0] > PITCH_UPSTEP * old_lag) | (
        lags[:, 0] < PITCH_DOWNSTEP * old_lag)
    old_lag = torch.where(jump, lags[:, 0], old_lag)
    old_gain = torch.where(jump, gains[:, 0], old_gain)
    if mode == "pre_gain":
        gain_mult[0] = jump.to(F32)

    index = 0
    cur_gain = old_gain
    coeffs = intrp[4].expand(N, -1)
    lag_offset = torch.full((N,), 52, dtype=I32, device=dev)
    for m in range(PITCH_SUBFRAMES):
        lag_delta = (lags[:, m] - old_lag) / PITCH_GRAN_PER_SUBFRAME
        cur_lag = old_lag
        gain_delta = (gains[:, m] - old_gain) / PITCH_GRAN_PER_SUBFRAME
        cur_gain = old_gain
        old_lag = lags[:, m]
        old_gain = gains[:, m]
        for _ in range(PITCH_GRAN_PER_SUBFRAME):
            cur_gain = cur_gain + gain_delta
            cur_lag = cur_lag + lag_delta
            # Update() (pitch_filter.c:218-241).
            lag_offset = torch.round(cur_lag + PITCH_FILTDELAY + 0.5).to(I32)
            fraction = lag_offset.to(F32) - (cur_lag + PITCH_FILTDELAY)
            frac_idx = torch.clamp(
                torch.round(PITCH_FRACS * fraction - 0.5).to(I32), 0,
                PITCH_FRACS - 1)
            coeffs = intrp[frac_idx.long()]
            if mode == "pre_gain":
                gain_mult[m] = torch.clamp(gain_mult[m] + 0.2, max=1.0)
                if m > 0:
                    gain_mult[m - 1] = gain_mult[m - 1] - 0.2
            buf, seg, out_dg_pad, damper, damper_dg = _filter_granule(
                in_data, buf, out_dg_pad, damper, damper_dg, coeffs,
                cur_gain, lag_offset, index, PITCH_UPDATE, mode, m,
                gain_mult)
            outs.append(seg)
            index += PITCH_UPDATE

    new_pf = pf
    if mode != "pre_gain":
        new_pf = pf.replace(
            ubuf=buf[:, PITCH_FRAME_LEN:PITCH_FRAME_LEN + PITCH_BUFFSIZE],
            ystate=damper, oldlag=old_lag, oldgain=old_gain)
    if mode in ("pre_gain", "pre_la"):
        # The 24-sample lookahead as two 12-sample granules, so no
        # fractional-lag read overlaps the granule's writes.
        for _ in range(2):
            buf, seg, out_dg_pad, damper, damper_dg = _filter_granule(
                in_data, buf, out_dg_pad, damper, damper_dg, coeffs,
                cur_gain, lag_offset, index, QLOOKAHEAD // 2, mode,
                PITCH_SUBFRAMES - 1, gain_mult)
            outs.append(seg)
            index += QLOOKAHEAD // 2
    out = torch.cat(outs, 1)
    if out.shape[1] < total:
        out = torch.cat([out, out.new_zeros((N, total - out.shape[1]))], 1)
    return new_pf, out, out_dg_pad[:, :, _DG_PAD:]


# ------------------------------------------------- pitch initialization


@dataclass
class PitchAnalysisState(_State):
    dec_buffer: torch.Tensor  # (N, 72)
    decimator_state: torch.Tensor  # (N, 5)
    hp_state: torch.Tensor  # (N, 2)
    whitened_buf: torch.Tensor  # (N, 24)
    inbuf: torch.Tensor  # (N, 24)
    pf_wght: PitchFiltState
    pf: PitchFiltState
    wght: WeightFiltState


def init_pitch_analysis(batch: int, device) -> PitchAnalysisState:
    return PitchAnalysisState(
        dec_buffer=_zeros(batch, DEC_KEEP, device),
        decimator_state=_zeros(batch, 2 * ALLPASSSECTIONS + 1, device),
        hp_state=_zeros(batch, 2, device),
        whitened_buf=_zeros(batch, QLOOKAHEAD, device),
        inbuf=_zeros(batch, QLOOKAHEAD, device),
        pf_wght=init_pitch_filt(batch, device),
        pf=init_pitch_filt(batch, device),
        wght=init_weight_filt(batch, device),
    )


def _decimate_allpass(x, dec_state):
    """WebRtcIsac_DecimateAllpass (pitch_estimator.c:147-171) with both
    two-section branches on K1."""
    n = x.shape[1]
    data = torch.cat([dec_state[:, 4:5], x[:, :n - 1]], 1)
    up, st_up = _allpass_cascade(data[:, 1::2], UPPER_AP, dec_state[:, :2])
    lo, st_lo = _allpass_cascade(data[:, 0::2], LOWER_AP, dec_state[:, 2:4])
    return lo + up, torch.cat([st_up, st_lo, x[:, n - 1:]], 1)


def _pcorr_ordered(buf):
    """PCorr (pitch_estimator.c:96-127), ordered by lag: the reversed
    series of window shifts."""
    x0 = PITCH_MAX_LAG // 2 + 2
    x = buf[:, x0:x0 + PITCH_CORR_LEN2]
    wins = _windows(buf, PITCH_CORR_LEN2, PITCH_LAG_SPAN2)  # (N, 65, 60)
    sums = torch.einsum("nkt,nt->nk", wins, x)
    ysums = 1e-13 + torch.sum(wins * wins, 2)
    return (sums / torch.sqrt(ysums)).flip(1)


def _candidates() -> np.ndarray:
    """The peak candidates' flat surface positions in the reference's scan
    order."""
    rows, cols = [], []
    for m in range(1, PITCH_BW + 1):
        for kk in range(2, PITCH_LAG_SPAN2 - PITCH_BW - 2 + m):
            rows.append(m)
            cols.append(kk)
    for m in range(PITCH_BW + 1, 2 * PITCH_BW):
        for kk in range(2 + m - PITCH_BW, PITCH_LAG_SPAN2 - 2):
            rows.append(m)
            cols.append(kk)
    return np.array(rows) * W_SURF + np.array(cols)


_CAND_P = _candidates()
_LAGWIN = np.array([0.2, 0.5, 0.98] + [1.0] * (PITCH_LAG_SPAN2 - 6)
                   + [0.98, 0.5, 0.2], np.float32)


def initialize_pitch(state: PitchAnalysisState, weighted, old_lag,
                     old_gain):
    """WebRtcIsac_InitializePitch (pitch_estimator.c:175-480).

    weighted: (N, 240); old_lag, old_gain: (N,). Returns (state, lags
    (N, 4))."""
    N = weighted.shape[0]
    dev = weighted.device
    dec, dec_state = _decimate_allpass(weighted, state.decimator_state)
    buf0 = torch.cat([state.dec_buffer, dec], 1)

    # y = x + 0.75 y[-1] - 0.25 y[-2] over the new samples, on K1.
    tail = _all_pole2(buf0[:, DEC_KEEP:], _DEC_LOWPASS,
                      buf0[:, DEC_KEEP - 1], buf0[:, DEC_KEEP - 2])
    buf = torch.cat([buf0[:, :DEC_KEEP], tail], 1)
    state = state.replace(
        dec_buffer=buf[:, PITCH_FRAME_LEN // 2:PITCH_FRAME_LEN // 2
                       + DEC_KEEP],
        decimator_state=dec_state)

    corrvec1 = _pcorr_ordered(buf)
    corrvec2 = _pcorr_ordered(buf[:, PITCH_CORR_STEP2:])

    log_lag = torch.log(0.5 * old_lag)[:, None]
    gain_bias = torch.clamp(4.0 * old_gain * old_gain, max=0.8)[:, None]
    k = torch.arange(PITCH_LAG_SPAN2, dtype=F32, device=dev)
    ratio = torch.log(k + (PITCH_MIN_LAG // 2 - 2)) - log_lag
    corrvec1 = corrvec1 * (1.0 + gain_bias * torch.exp(-5.0 * ratio * ratio))
    lagwin = _c(_LAGWIN, dev)
    corrvec1 = corrvec1 * lagwin
    corrvec2 = corrvec2 * lagwin

    # The correlation surface, rows 0 .. 2 BW + 2.
    n_rows = 2 * PITCH_BW + 3
    surf = weighted.new_zeros((N, n_rows, W_SURF))
    surf[:, PITCH_BW, 2:2 + PITCH_LAG_SPAN2] = corrvec1 + corrvec2
    for m in range(PITCH_BW):
        m_off = PITCH_BW - m
        scale = {PITCH_BW: 0.2, PITCH_BW - 1: 0.9}.get(m_off, 1.0)
        length = PITCH_LAG_SPAN2 - m_off
        i1 = torch.arange(length, device=dev)
        i2 = i1 + m_off
        r = (i1 + 12).to(F32) / (i2 + 12).to(F32)
        adj = scale * r * (2.0 - r)
        surf[:, m, 2:2 + length] = adj * (corrvec1[:, i1] + corrvec2[:, i2])
        surf[:, 2 * PITCH_BW - m, 2 + m_off:2 + m_off + length] = adj * (
            corrvec1[:, i2] + corrvec2[:, i1])

    flat = surf.reshape(N, -1)
    PAD = 3 * W_SURF
    padded = torch.cat([flat.new_zeros((N, PAD)), flat,
                        flat.new_zeros((N, PAD))], 1)
    corr_max_all = torch.amax(flat, 1)
    max_ind = torch.argmax(flat, 1).to(I32)

    # The first 10 peaks in the reference's scan order.
    cand_p = _c(_CAND_P, dev, torch.int64)
    W = W_SURF

    def g(i):
        """padded at flat positions i (N, ...) int64."""
        return torch.gather(padded, 1, (i + PAD).reshape(N, -1)).reshape(
            i.shape)

    cp = cand_p.expand(N, -1)
    cv = g(cp)
    is_peak = ((cv > corr_max_all[:, None] * 0.6) & (cv > g(cp - (W + 1)))
               & (cv > g(cp - W)) & (cv > g(cp + W))
               & (cv > g(cp + W + 1)))
    order = torch.cumsum(is_peak.to(I32), 1)
    keep = is_peak & (order <= PITCH_MAX_NUM_PEAKS)
    n_peaks = torch.sum(keep.to(I32), 1)
    slot_of = torch.where(keep, order - 1, PITCH_MAX_NUM_PEAKS).long()
    slots_p = torch.zeros((N, PITCH_MAX_NUM_PEAKS + 1), dtype=torch.int64,
                          device=dev)
    slots_p = slots_p.scatter(1, slot_of, cp)[:, :PITCH_MAX_NUM_PEAKS]
    slot_valid = (torch.arange(PITCH_MAX_NUM_PEAKS, device=dev)
                  < n_peaks[:, None])

    iwin = _c(INTERPOL_WIN, dev)
    taps = torch.arange(-3, 5, device=dev)

    def interp_at(i):
        w = torch.gather(padded, 1, (i[..., None] + PAD + taps).reshape(
            N, -1)).reshape(i.shape + (8,))
        return torch.sum(w * iwin, -1)

    p = slots_p
    ia = interp_at(p - (W + 1))
    ib = interp_at(p - 1)
    ic = interp_at(p)
    idd = interp_at(p + W)
    corr = g(p)
    cmax = torch.maximum(torch.maximum(ia, ib), torch.maximum(ic, idd))
    row = p // W
    l1 = (p - row * W + (PITCH_MIN_LAG // 2 - 4)).to(F32)
    l2 = l1 + (PITCH_BW - row).to(F32)
    c_gt = corr > cmax
    a_mx = ia == cmax
    b_mx = ib == cmax
    c_mx = ic == cmax

    def tsel(main, va, vb, vc, vd):
        return torch.where(c_gt, main, torch.where(
            a_mx, va, torch.where(b_mx, vb, torch.where(c_mx, vc, vd))))

    def fsel(*vals):
        return tsel(*(torch.full_like(ia, v) for v in vals))

    T00 = tsel(g(p - (W + 1)), interp_at(p - 2 * (W + 1)),
               interp_at(p - (W + 2)), ia, ib)
    T20 = tsel(g(p - W), interp_at(p - (2 * W + 1)), ia, interp_at(p - W),
               ic)
    T11 = tsel(corr, ia, ib, ic, idd)
    T02 = tsel(g(p + W), ib, interp_at(p + W - 1), idd, interp_at(p + 2 * W))
    T22 = tsel(g(p + W + 1), ic, idd, interp_at(p + W + 1),
               interp_at(p + 2 * W + 1))
    T10 = tsel(ia, g(p - (2 * W + 1)), g(p - (W + 1)), g(p - W), corr)
    T01 = tsel(ib, g(p - (W + 1)), g(p - 1), corr, g(p + W))
    T21 = tsel(ic, g(p - W), corr, g(p + 1), g(p + W + 1))
    T12 = tsel(idd, corr, g(p + W), g(p + W + 1), g(p + 2 * W + 1))
    l1b = l1 + fsel(0.0, -0.5, -0.5, 0.5, 0.5)
    l2b = l2 + fsel(0.0, 0.5, -0.5, 0.5, -0.5)

    # Intrpol2D (pitch_estimator.c:43-93).
    c = T11
    b0 = 0.5 * (T12 + T21 - T01 - T10)
    b1 = 0.5 * (T10 + T21 - T01 - T12)
    A01 = -0.5 * (T01 + T21 - T10 - T12)
    t1 = 0.5 * (T00 + T22) - c
    t2 = 0.5 * (T20 + T02) - c
    d = (T01 + T12 + T10 + T21) - 4.0 * c - t1 - t2
    A00 = -t1 - 0.5 * d
    A11 = -t2 - 0.5 * d
    singular = (A00 < 1e-7) | ((A00 * A11 - A01 * A01) < 1e-7)
    A00s = torch.sqrt(torch.clamp(A00, min=1e-20))
    A01n = A01 / A00s
    A11s = torch.sqrt(torch.clamp(A11 - A01n * A01n, min=1e-20))
    t1c = b0 / A00s
    t2c = (b1 - t1c * A01n) / A11s
    delta2 = t2c / A11s
    delta1 = 0.5 * (t1c - delta2 * A01n) / A00s
    delta2 = delta2 * 0.5
    nrm = delta1 * delta1 + delta2 * delta2
    scl = torch.where(nrm > 1.0, 1.0 / torch.clamp(nrm, min=1e-20), 1.0)
    delta1 = delta1 * scl
    delta2 = delta2 * scl
    peak_val = 0.5 * (b0 * delta1 + b1 * delta2) + c
    l1s = torch.where(singular, l1b, l1b + delta1)
    l2s = torch.where(singular, l2b, l2b + delta2)
    pvs = torch.where(singular, T11, peak_val)

    biased = pvs * torch.pow(PITCH_PEAK_DECAY,
                             torch.log(torch.clamp(l1s + l2s, min=1e-6)))
    biased = torch.where(slot_valid & (biased > 0), biased, -torch.inf)
    best = torch.argmax(biased, 1, keepdim=True)
    l1 = torch.clamp(torch.gather(l1s, 1, best)[:, 0] * 2.0, PITCH_MIN_LAG,
                     PITCH_MAX_LAG)
    l2 = torch.clamp(torch.gather(l2s, 1, best)[:, 0] * 2.0, PITCH_MIN_LAG,
                     PITCH_MAX_LAG)

    # Fallback when no peak qualifies.
    row_f = max_ind // W_SURF
    l1f = (max_ind - row_f * W_SURF + (PITCH_MIN_LAG // 2 - 4)).to(F32)
    l2f = l1f + (PITCH_BW - row_f).to(F32)
    l1f = torch.clamp(l1f, PITCH_MIN_LAG, PITCH_MAX_LAG)
    l2f = torch.clamp(l2f, PITCH_MIN_LAG, PITCH_MAX_LAG)
    have = n_peaks > 0
    l1 = torch.where(have, l1, l1f)
    l2 = torch.where(have, l2, l2f)
    return state, torch.stack([l1, l1, l2, l2], 1)


# The pitch analysis's input HPF, (a0, a1, b0, b1) as float32 values, and
# its DF1 row [1, b0, b1, -a0, -a1] (pitch_estimator.c:562-573).
_PITCH_HP = tuple(float(np.float32(v)) for v in (
    1.86864659625574, -0.88360000000000, -1.99524591718270,
    0.99600400000000))
_PITCH_HP_ROWS = np.array([[1.0, _PITCH_HP[2], _PITCH_HP[3], -_PITCH_HP[0],
                            -_PITCH_HP[1]]], np.float32)
_GAIN_DIAG = np.array([1.0, 1.0, 1.0, 1.33], np.float32)


def pitch_analysis(state: PitchAnalysisState, inp):
    """WebRtcIsac_PitchAnalysis (pitch_estimator.c:547-695).

    inp: (N, 240), the lower-band signal. Returns (state, lags (N, 4),
    gains (N, 4))."""
    N = inp.shape[0]
    dev = inp.device
    # The input HPF, transposed direct form II: y = x + s1,
    # s1' = s0 + b0 x + a0 y, s0' = b1 x + a1 y. As a DF1 biquad
    # [1, b0, b1] / [1, -a0, -a1] on K1, its state (s0, s1) entering as a
    # history with x[-1] = x[-2] = 0 and leaving from the DF1 history.
    a0, a1, b0, b1 = _PITCH_HP
    s0, s1 = state.hp_state[:, 0], state.hp_state[:, 1]
    y1 = s0 / a1
    y2 = (s1 - a0 * y1) / a1
    zero = torch.zeros_like(y1)
    st4, hpin = _k1(_PITCH_HP_ROWS, torch.stack([zero, zero, y1, y2]), inp)
    x1, x2, y1, y2 = st4.unbind(0)
    hp_state = torch.stack(
        [b1 * x1 + a1 * y1, b0 * x1 + b1 * x2 + a0 * y1 + a1 * y2], 1)
    state = state.replace(hp_state=hp_state)

    wght, weighted, whit_new = weighting_filter(state.wght, hpin)
    whitened = torch.cat([state.whitened_buf, whit_new], 1)
    state = state.replace(wght=wght,
                          whitened_buf=whitened[:, PITCH_FRAME_LEN:])

    old_lag = state.pf_wght.oldlag
    old_gain = state.pf_wght.oldgain
    state, lags = initialize_pitch(state, weighted, old_lag, old_gain)

    nrg_wht = torch.clamp(torch.sum(whitened * whitened, 1), min=1e-12)
    Wnrg = (1.0 / nrg_wht)[:, None]
    Wgain = 0.005
    Wfluct = 3.0
    gains = torch.full((N, 4), PITCH_MAX_GAIN_06, dtype=F32, device=dev)
    kW = _c(GAIN_WEIGHT, dev)
    wvec = _c(_GAIN_DIAG, dev)

    for _ in range(2):
        _, out_g, out_dg = pitch_filter_frame(whitened, state.pf_wght, lags,
                                              gains, "pre_gain")
        grad = torch.einsum("njt,nt->nj", out_dg, out_g) * Wnrg
        H = torch.einsum("njt,nkt->njk", out_dg, out_dg) * Wnrg[:, :, None]
        grad = grad + (kW[1:, 0] * old_gain[:, None]
                       + gains @ kW[1:, 1:].t()) * Wfluct
        H = H + kW[1:, 1:] * Wfluct
        tmp = 1.0 / (1.0 - gains)
        gd = tmp * tmp * Wgain
        grad = grad + gd * wvec
        H = H + torch.diag_embed(2.0 * tmp * gd * wvec)

        # The 4 x 4 Cholesky solve, hand-rolled as the reference (:640-668).
        H00 = H[:, 0, 0]
        H01 = H[:, 1, 0] / H00
        H02 = H[:, 2, 0] / H00
        H03 = H[:, 3, 0] / H00
        H11 = H[:, 1, 1] - H00 * H01 * H01
        H12 = (H[:, 2, 1] - H01 * H[:, 2, 0]) / H11
        H13 = (H[:, 3, 1] - H01 * H[:, 3, 0]) / H11
        H22 = H[:, 2, 2] - H00 * H02 * H02 - H11 * H12 * H12
        H23 = (H[:, 3, 2] - H02 * H[:, 3, 0] - H12 * H11 * H13) / H22
        H33 = (H[:, 3, 3] - H00 * H03 * H03 - H11 * H13 * H13
               - H22 * H23 * H23)
        d0 = -grad[:, 0]
        d1 = -grad[:, 1] - d0 * H01
        d2 = -grad[:, 2] - d0 * H02 - d1 * H12
        d3 = -grad[:, 3] - d0 * H03 - d1 * H13 - d2 * H23
        d0 = d0 / H00
        d1 = d1 / H11
        d2 = d2 / H22
        d3 = d3 / H33
        d2 = d2 - d3 * H23
        d1 = d1 - d3 * H13 - d2 * H12
        d0 = d0 - d3 * H03 - d2 * H02 - d1 * H01
        gains = torch.clamp(gains + torch.stack([d0, d1, d2, d3], 1), 0.0,
                            PITCH_MAX_GAIN)

    new_pf_wght, _, _ = pitch_filter_frame(whitened, state.pf_wght, lags,
                                           gains, "pre")
    inbuf = torch.cat([state.inbuf, inp], 1)
    new_pf, _, _ = pitch_filter_frame(inbuf, state.pf, lags, gains, "pre_la")
    state = state.replace(pf_wght=new_pf_wght, pf=new_pf,
                          inbuf=inbuf[:, PITCH_FRAME_LEN:])
    return state, lags, gains


# ------------------------------------------------------- VadAudioProc


@dataclass
class VadAudioProcState(_State):
    audio_buffer: torch.Tensor  # (N, 560)
    hpf_past_in: torch.Tensor  # (N, 2)
    hpf_past_out: torch.Tensor  # (N, 2)
    log_old_gain: torch.Tensor  # (N,)
    old_lag: torch.Tensor  # (N,)
    pitch: PitchAnalysisState
    prefilt: PreFiltBankState


def init_audio_proc(batch: int, device) -> VadAudioProcState:
    return VadAudioProcState(
        audio_buffer=_zeros(batch, BUFFER_LENGTH, device),
        hpf_past_in=_zeros(batch, 2, device),
        hpf_past_out=_zeros(batch, 2, device),
        log_old_gain=torch.full((batch,), -2.0, dtype=F32, device=device),
        old_lag=torch.full((batch,), 50.0, dtype=F32, device=device),
        pitch=init_pitch_analysis(batch, device),
        prefilt=init_prefilt(batch, device),
    )


_LPC_ANAL_WIN = _lpc_anal_win().astype(np.float32)
_HPF_ROWS = np.concatenate([HPF_NUMERATOR, HPF_DENOMINATOR[1:]])[None]


def _pole_zero_hpf(state: VadAudioProcState, frame):
    """PoleZeroFilter::Filter with kCoeffNumerator/Denominator
    (pole_zero_filter.cc:73-103), a DF1 biquad on K1."""
    st4 = torch.stack([state.hpf_past_in[:, 0], state.hpf_past_in[:, 1],
                       state.hpf_past_out[:, 0], state.hpf_past_out[:, 1]])
    st4, ys = _k1(_HPF_ROWS, st4, frame)
    return (state.replace(hpf_past_in=st4[:2].t().contiguous(),
                          hpf_past_out=st4[2:].t().contiguous()), ys)


def _subframe_lpc_peaks(audio_buffer):
    """GetLpcPolynomials and FindFirstSpectralPeaks (vad_audio_proc.cc:
    120-230). Returns the spectral peaks (N, 3) in Hz."""
    N = audio_buffer.shape[0]
    dev = audio_buffer.device
    win = _c(_LPC_ANAL_WIN, dev)
    segs = torch.stack([audio_buffer[:, s:s + 240] for s in
                        range(0, NUM_10MS_SUBFRAMES * NUM_SUBFRAME_SAMPLES,
                              NUM_SUBFRAME_SAMPLES)], 1)  # (N, 3, 240)
    corr = _autocorr(segs * win, LPC_ORDER)  # (N, 3, 17)
    corr = torch.cat([corr[..., :1] * 1.0001, corr[..., 1:]], -1)
    corr = corr * _c(CORR_WEIGHT, dev)
    lpc = _lev_durb(corr, LPC_ORDER)
    data = torch.cat([lpc, lpc.new_zeros((N, NUM_10MS_SUBFRAMES,
                                          DFT_SIZE - LPC_ORDER - 1))], -1)
    spec = torch.fft.rfft(data, DFT_SIZE, dim=-1)
    magn_sqr = spec.real ** 2 + spec.imag ** 2  # (N, 3, 257)

    # The main scan (vad_audio_proc.cc:186-205): candidate minima are bins
    # 1..254, the first hit wins.
    n_coef = DFT_SIZE // 2 + 1
    prev = magn_sqr[..., 0:n_coef - 2]
    curr = magn_sqr[..., 1:n_coef - 1]
    nxt = magn_sqr[..., 2:n_coef]
    is_min = (curr < prev) & (curr < nxt)
    cand = is_min[..., :n_coef - 3]
    found = cand.any(-1)
    j = torch.argmax(cand.to(I32), -1, keepdim=True)
    index_peak = torch.where(found, j[..., 0] + 1, 0)
    p_prev = torch.gather(prev, -1, j)[..., 0]
    p_curr = torch.gather(curr, -1, j)[..., 0]
    p_next = torch.gather(nxt, -1, j)[..., 0]
    # QuadraticInterpolation (vad_audio_proc.cc:162-177) on inverses.
    nv = 1.0 / torch.clamp(p_next, min=1e-30)
    pv = 1.0 / torch.clamp(p_prev, min=1e-30)
    cv = 1.0 / torch.clamp(p_curr, min=1e-30)
    denom = nv + pv - 2.0 * cv
    frac = torch.where(torch.abs(denom) > 1e-30, -(nv - pv) * 0.5 / denom,
                       0.0)
    frac = torch.where(found, frac, 0.0)
    # The tail check (:206-211): bin 255 a local minimum reports 256.
    last_is_min = (~found & (magn_sqr[..., 255] < magn_sqr[..., 254])
                   & (magn_sqr[..., 255] < magn_sqr[..., 256]))
    index_peak = torch.where(last_is_min, n_coef - 1, index_peak)
    return (index_peak.to(F32) + frac) * FREQ_RESOLUTION


def extract_features(state: VadAudioProcState, frame, full: bool):
    """VadAudioProc::ExtractFeatures (vad_audio_proc.cc:84-123).

    frame: (N, 160) int16-valued floats at 16 kHz; ``full`` (static) is
    true on every third call, when the 30 ms buffer is complete. Returns
    (state, features), features a dict of rms, log_pitch_gain,
    pitch_lag_hz, spectral_peak (N, 3) and silence (N,); None unless
    ``full``."""
    state, filtered = _pole_zero_hpf(state, frame)
    # The fill level cycles 80 -> 240 -> 400 -> 560, so append and
    # ResetBuffer collapse into a rolling buffer.
    state = state.replace(audio_buffer=torch.cat(
        [state.audio_buffer[:, LENGTH_10MS:], filtered], 1))
    if not full:
        return state, None

    audio = state.audio_buffer
    seg = audio[:, NUM_PAST_SIGNAL_SAMPLES:].reshape(
        -1, 3, NUM_SUBFRAME_SAMPLES)
    rms = torch.sqrt(torch.mean(seg * seg, -1))
    silence = (rms < SILENCE_RMS).any(1)

    # Pitch analysis (vad_audio_proc.cc:246-270).
    prefilt, lp, hp, lp_la, hp_la = split_and_filter(
        state.prefilt, audio[:, NUM_PAST_SIGNAL_SAMPLES:])
    pitch, lags4, gains4 = pitch_analysis(state.pitch, lp_la)

    # GetSubframesPitchParameters (pitch_internal.cc:24-55).
    log_gains = torch.log(gains4 + 1e-12)
    log_pitch_gain = torch.stack([
        1.0 / 6.0 * state.log_old_gain + 5.0 / 6.0 * log_gains[:, 0],
        5.0 / 6.0 * log_gains[:, 1] + 1.0 / 6.0 * log_gains[:, 2],
        0.5 * log_gains[:, 2] + 0.5 * log_gains[:, 3],
    ], 1)
    lag_interp = torch.stack([
        1.0 / 6.0 * state.old_lag + 5.0 / 6.0 * lags4[:, 0],
        5.0 / 6.0 * lags4[:, 1] + 1.0 / 6.0 * lags4[:, 2],
        0.5 * lags4[:, 2] + 0.5 * lags4[:, 3],
    ], 1)
    pitch_lag_hz = (SAMPLE_RATE_HZ / 2.0) / lag_interp
    spectral_peak = _subframe_lpc_peaks(audio)

    # The state holds on silence (the reference returns before
    # PitchAnalysis).
    state = state.replace(
        prefilt=tree_where(silence, state.prefilt, prefilt),
        pitch=tree_where(silence, state.pitch, pitch),
        log_old_gain=torch.where(silence, state.log_old_gain,
                                 log_gains[:, 3]),
        old_lag=torch.where(silence, state.old_lag, lags4[:, 3]),
    )
    return state, {
        "rms": rms,
        "log_pitch_gain": log_pitch_gain,
        "pitch_lag_hz": pitch_lag_hz,
        "spectral_peak": spectral_peak,
        "silence": silence,
    }


# --------------------------------------------------- pitch-based VAD

NOISE_GMM_WEIGHTS = np.array([
    -1.09422832086193e+01, -1.10847897513425e+01, -1.36767587732187e+01,
    -1.79789356118641e+01, -1.42830169160894e+01, -1.56500228061379e+01,
    -1.83124990950113e+01, -1.69979436177477e+01, -1.12329424387828e+01,
    -1.41311785780639e+01, -1.47171861448585e+01, -1.35963362781839e+01])

VOICE_GMM_WEIGHTS = np.array([
    -1.39789694361035e+01, -1.19527720202104e+01, -1.32396317929055e+01,
    -1.09436815209238e+01, -1.13440027478149e+01, -1.12200721834504e+01,
    -1.02537324043693e+01, -1.60789861938302e+01, -1.03394494048344e+01,
    -1.83207938586818e+01, -1.31186044948288e+01, -9.52479998673554e+00])

NOISE_GMM_MEAN = np.array([
    [-2.01386094766163e+00, 1.69702162045397e+02, 7.41715804872181e+01],
    [-1.94684591777290e+00, 1.42398396732668e+02, 1.64186321157831e+02],
    [-2.29319297562437e+00, 3.86415425589868e+02, 2.13452215267125e+02],
    [-3.25487177070268e+00, 1.08668712553616e+03, 2.33119949467419e+02],
    [-2.13159632447467e+00, 4.83821702557717e+03, 6.86786166673740e+01],
    [-2.26171410780526e+00, 4.79420193982422e+03, 1.53222513286450e+02],
    [-3.32166740703185e+00, 4.35161135834358e+03, 1.33206448431316e+02],
    [-2.19290322814343e+00, 3.98325506609408e+03, 2.13249167359934e+02],
    [-2.02898459255404e+00, 7.37039893155007e+03, 1.12518527491926e+02],
    [-2.26150236399500e+00, 1.54896745196145e+03, 1.49717357868579e+02],
    [-2.00417668301790e+00, 3.82434760310304e+03, 1.07438913004312e+02],
    [-2.30193040814533e+00, 1.43953696546439e+03, 7.04085275122649e+01]])

VOICE_GMM_MEAN = np.array([
    [-2.15020241646536e+00, 4.97079062999877e+02, 4.77078119504505e+02],
    [-8.92097680029190e-01, 5.92064964199921e+02, 1.81045145941059e+02],
    [-1.29435784144398e+00, 4.98450293410611e+02, 1.71991263804064e+02],
    [-1.03925228397884e+00, 4.99511274321571e+02, 1.05838336539105e+02],
    [-1.29229047206129e+00, 4.15026762566707e+02, 1.12861119017125e+02],
    [-7.88748114599810e-01, 4.48739336688113e+02, 1.89784216956337e+02],
    [-8.77777402332642e-01, 4.86620285054533e+02, 1.13477708016491e+02],
    [-2.06465957063057e+00, 6.33385049870607e+02, 2.32758546796149e+02],
    [-6.98893789231685e-01, 5.93622051503385e+02, 1.92536982473203e+02],
    [-2.55901217508894e+00, 1.55914919756205e+03, 1.39769980835570e+02],
    [-1.92070024165837e+00, 4.87983940444185e+02, 1.02745468128289e+02],
    [-7.29187507662854e-01, 5.22717685022855e+02, 1.16377942283991e+02]])

NOISE_GMM_COVAR_INV = np.array([
    [[7.36219567592941e+00, 4.83060785179861e-03, 1.23335151497610e-02],
     [4.83060785179861e-03, 1.65289507047817e-04, -2.41490588169997e-04],
     [1.23335151497610e-02, -2.41490588169997e-04, 6.59472060689382e-03]],
    [[8.70265239309140e+00, -5.30636201431086e-04, 5.44014966585347e-03],
     [-5.30636201431086e-04, 3.11095453521008e-04, -1.86287206836035e-04],
     [5.44014966585347e-03, -1.86287206836035e-04, 6.29493388790744e-04]],
    [[4.53467851955055e+00, -3.92977536695197e-03, -2.46521420693317e-03],
     [-3.92977536695197e-03, 4.94650752632750e-05, -1.08587438501826e-05],
     [-2.46521420693317e-03, -1.08587438501826e-05, 9.28793975422261e-05]],
    [[9.26817997114275e-01, -4.03976069276753e-04, -3.56441427392165e-03],
     [-4.03976069276753e-04, 2.51976251631430e-06, 1.46914206734572e-07],
     [-3.56441427392165e-03, 1.46914206734572e-07, 8.19914567685373e-05]],
    [[7.61715986787441e+00, -1.54889041216888e-04, 2.41756280071656e-02],
     [-1.54889041216888e-04, 3.50282550461672e-07, -6.27251196972490e-06],
     [2.41756280071656e-02, -6.27251196972490e-06, 1.45061847649872e-02]],
    [[8.31193642663158e+00, -3.84070508164323e-04, -3.09750630821876e-02],
     [-3.84070508164323e-04, 3.80433432277336e-07, -1.14321142836636e-06],
     [-3.09750630821876e-02, -1.14321142836636e-06, 8.35091486289997e-04]],
    [[9.67283151270894e-01, 5.82465812445039e-05, -3.18350798617053e-03],
     [5.82465812445039e-05, 2.23762672000318e-07, -7.74196587408623e-07],
     [-3.18350798617053e-03, -7.74196587408623e-07, 3.85120938338325e-04]],
    [[8.28066236985388e+00, 5.87634508319763e-05, 6.99303090891743e-03],
     [5.87634508319763e-05, 2.93746018618058e-07, 3.40843332882272e-07],
     [6.99303090891743e-03, 3.40843332882272e-07, 1.99379171190344e-04]],
    [[6.07488998675646e+00, -1.11494526618473e-02, 5.10013111123381e-03],
     [-1.11494526618473e-02, 6.99238879921751e-04, 5.36718550370870e-05],
     [5.10013111123381e-03, 5.36718550370870e-05, 5.26909853276753e-04]],
    [[6.90492021419175e+00, 4.20639355257863e-04, -2.38612752336481e-03],
     [4.20639355257863e-04, 3.31246767338153e-06, -2.42052288150859e-08],
     [-2.38612752336481e-03, -2.42052288150859e-08, 4.46608368363412e-04]],
    [[1.31069150869715e+01, -1.73718583865670e-04, -1.97591814508578e-02],
     [-1.73718583865670e-04, 2.80451716300124e-07, 9.96570755379865e-07],
     [-1.97591814508578e-02, 9.96570755379865e-07, 2.41361900868847e-03]],
    [[4.69566344239814e+00, -2.61077567563690e-04, 5.26359000761433e-03],
     [-2.61077567563690e-04, 1.82420859823767e-06, -7.83645887541601e-07],
     [5.26359000761433e-03, -7.83645887541601e-07, 1.33586288288802e-02]]])

VOICE_GMM_COVAR_INV = np.array([
    [[1.83673825579513e+00, -8.09791637570095e-04, 4.60106414365986e-03],
     [-8.09791637570095e-04, 8.89351738394608e-04, -9.80188953277734e-04],
     [4.60106414365986e-03, -9.80188953277734e-04, 1.38706060206582e-03]],
    [[6.76228912850703e+01, -1.98893120119660e-02, -3.53548357253551e-03],
     [-1.98893120119660e-02, 3.96216858500530e-05, -4.08492938394097e-05],
     [-3.53548357253551e-03, -4.08492938394097e-05, 9.31864352856416e-04]],
    [[9.98612435944558e+00, -5.27880954316893e-03, -6.30342541619017e-03],
     [-5.27880954316893e-03, 4.54359480225226e-05, 6.30804591626044e-05],
     [-6.30342541619017e-03, 6.30804591626044e-05, 5.36466441382942e-04]],
    [[3.39917474216349e+01, -1.56213579433191e-03, -4.01459014990225e-02],
     [-1.56213579433191e-03, 6.40415424897724e-05, 6.20076342427833e-05],
     [-4.01459014990225e-02, 6.20076342427833e-05, 3.51199070103063e-03]],
    [[1.34545062271428e+01, -7.94513610147144e-03, -5.34401019341728e-02],
     [-7.94513610147144e-03, 1.16511820098649e-04, 4.66063702069293e-05],
     [-5.34401019341728e-02, 4.66063702069293e-05, 2.72354323774163e-03]],
    [[1.08557844314806e+02, -1.54885805673668e-02, -1.88029692674851e-02],
     [-1.54885805673668e-02, 1.16404042786406e-04, 6.45579292702802e-06],
     [-1.88029692674851e-02, 6.45579292702802e-06, 4.32330478391416e-04]],
    [[8.22940066541450e+01, -1.15903110231303e-02, -4.92166764865343e-02],
     [-1.15903110231303e-02, 7.42510742165261e-05, 3.73007314191290e-06],
     [-4.92166764865343e-02, 3.73007314191290e-06, 3.64005221593244e-03]],
    [[2.31133605685660e+00, -7.83261568950254e-04, 7.45744012346313e-04],
     [-7.83261568950254e-04, 1.29460648214142e-05, -2.22774455093730e-06],
     [7.45744012346313e-04, -2.22774455093730e-06, 1.05117294093010e-04]],
    [[3.78767849189611e+02, 1.57759761011568e-03, -2.08551217988774e-02],
     [1.57759761011568e-03, 4.76066236886865e-05, -2.33977412299324e-05],
     [-2.08551217988774e-02, -2.33977412299324e-05, 5.24261005371196e-04]],
    [[6.98580096506135e-01, -5.13850255217378e-04, -4.01124551717056e-04],
     [-5.13850255217378e-04, 1.40501021984840e-06, -2.09496928716569e-06],
     [-4.01124551717056e-04, -2.09496928716569e-06, 2.82879357740037e-04]],
    [[2.62770945162399e+00, -2.31825753241430e-03, -5.30447217466318e-03],
     [-2.31825753241430e-03, 4.59108572227649e-05, 7.67631886355405e-05],
     [-5.30447217466318e-03, 7.67631886355405e-05, 2.28521601674098e-03]],
    [[1.89940391362152e+02, -4.23280856852379e-03, -2.70608873541399e-02],
     [-4.23280856852379e-03, 6.77547582742563e-05, 2.69154203800467e-05],
     [-2.70608873541399e-02, 2.69154203800467e-05, 3.88574543373470e-03]]])


def evaluate_gmm(x, weights, means, covar_inv):
    """EvaluateGmm (gmm.cc:42-61). x: (..., 3). Returns the pdf (...)."""
    dev = x.device
    d = x[..., None, :] - _c(means, dev)  # (..., 12, 3)
    q = -0.5 * torch.einsum("...mi,mij,...mj->...m", d,
                            _c(covar_inv, dev), d)
    return torch.sum(torch.exp(q + _c(weights, dev)), -1)


RING = 500


@dataclass
class PitchBasedVadState(_State):
    """PitchBasedVad and its VadCircularBuffer (pitch_based_vad.cc:57-66)."""

    p_prior: torch.Tensor  # (N,)
    ring: torch.Tensor  # (N, 500)
    ring_index: torch.Tensor  # (N,) int32
    ring_full: torch.Tensor  # (N,) bool
    ring_sum: torch.Tensor  # (N,)


def init_pitch_based_vad(batch: int, device) -> PitchBasedVadState:
    return PitchBasedVadState(
        p_prior=torch.full((batch,), 0.3, dtype=F32, device=device),
        ring=_zeros(batch, RING, device),
        ring_index=torch.zeros(batch, dtype=I32, device=device),
        ring_full=torch.zeros(batch, dtype=torch.bool, device=device),
        ring_sum=torch.zeros(batch, dtype=F32, device=device),
    )


def _ring_insert(st: PitchBasedVadState, value):
    idx = st.ring_index.long()[:, None]
    old = torch.gather(st.ring, 1, idx)[:, 0]
    sum_ = st.ring_sum - torch.where(st.ring_full, old, 0.0)
    ring = st.ring.scatter(1, idx, value[:, None])
    nxt = st.ring_index + 1
    return st.replace(ring=ring, ring_index=torch.remainder(nxt, RING),
                      ring_full=st.ring_full | (nxt >= RING),
                      ring_sum=sum_ + value)


def _ring_remove_transient(st: PitchBasedVadState):
    """VadCircularBuffer::RemoveTransient(7, 0.2)
    (vad_circular_buffer.cc:104-133)."""
    dev = st.ring.device
    level = torch.where(st.ring_full, RING, st.ring_index)
    enough = level >= 7 + 2
    ar9 = torch.arange(9, device=dev)
    # Logical index i (0 the newest) is linear index_ - 1 - i mod 500.
    lin = torch.remainder(st.ring_index.long()[:, None] - 1 - ar9, RING)
    vals = torch.gather(st.ring, 1, lin)
    newest_low = vals[:, 0] < 0.2
    desc = torch.arange(8, 0, -1, device=dev)
    low_desc = (vals < 0.2)[:, desc]
    has_break = low_desc.any(1)
    start = torch.where(has_break,
                        desc[torch.argmax(low_desc.to(I32), 1)], 0)
    zero_mask = ((ar9 >= 1) & (ar9 <= start[:, None])) | (ar9 == 0)
    act = (enough & newest_low)[:, None] & zero_mask
    ring = st.ring.scatter(1, lin, torch.where(act, 0.0, vals))
    sum_ = st.ring_sum - torch.sum(torch.where(act, vals, 0.0), 1)
    return st.replace(ring=ring, ring_sum=sum_)


def pitch_based_voicing(st: PitchBasedVadState, features, p_combined,
                        num_frames: int = NUM_10MS_SUBFRAMES):
    """PitchBasedVad::VoicingProbability (pitch_based_vad.cc:101-147).

    p_combined: (N, num_frames), the standalone probabilities. Returns
    (state, p (N, num_frames))."""
    outs = []
    for n in range(num_frames):
        sp = features["spectral_peak"][:, n]
        lg = features["log_pitch_gain"][:, n]
        x = torch.stack([lg, sp, features["pitch_lag_hz"][:, n]], 1)
        pdf_v = evaluate_gmm(x, VOICE_GMM_WEIGHTS, VOICE_GMM_MEAN,
                             VOICE_GMM_COVAR_INV)
        pdf_n = evaluate_gmm(x, NOISE_GMM_WEIGHTS, NOISE_GMM_MEAN,
                             NOISE_GMM_COVAR_INV)
        kEps = 1e-12
        low_voice = (sp < 200.0) | (sp > 2000.0) | (lg < -2.0)
        high_voice = lg > -0.9
        pdf_v2 = torch.where(low_voice, kEps * pdf_n, pdf_v)
        pdf_n2 = torch.where(~low_voice & high_voice, kEps * pdf_v2, pdf_n)
        p = st.p_prior * pdf_v2 / torch.clamp(
            pdf_v2 * st.p_prior + pdf_n2 * (1.0 - st.p_prior), min=1e-35)
        p = torch.clamp(p, 0.01, 0.99)
        prod_a = p * p_combined[:, n]
        prod_i = (1.0 - p) * (1.0 - p_combined[:, n])
        pc = prod_a / torch.clamp(prod_a + prod_i, min=1e-35)
        outs.append(pc)

        st = _ring_remove_transient(_ring_insert(st, pc))
        level = torch.where(st.ring_full, float(RING),
                            st.ring_index.to(F32))
        mean = torch.where(level > 0,
                           st.ring_sum / torch.clamp(level, min=1.0), 0.0)
        st = st.replace(p_prior=torch.clamp(mean, 0.01, 0.99))
    return st, torch.stack(outs, 1)


# ------------------------------------------- VoiceActivityDetector


@dataclass
class VoiceActivityDetectorState(_State):
    """voice_activity_detector.{h,cc}: the standalone VAD, the audio
    processor and the pitch-based VAD at a 30 ms cadence over 10 ms
    chunks."""

    audio_proc: VadAudioProcState
    pitch_vad: PitchBasedVadState
    standalone: legacy_vad.VadState
    sa_buffer: torch.Tensor  # (N, 480) int32, the 16 kHz samples
    last_probability: torch.Tensor  # (N,)


def init_voice_activity_detector(batch: int,
                                 device) -> VoiceActivityDetectorState:
    return VoiceActivityDetectorState(
        audio_proc=init_audio_proc(batch, device),
        pitch_vad=init_pitch_based_vad(batch, device),
        standalone=legacy_vad.init_state(batch, device),
        sa_buffer=torch.zeros((batch, 480), dtype=I32, device=device),
        last_probability=torch.ones(batch, dtype=F32, device=device),
    )


def process_chunk(state: VoiceActivityDetectorState, frame, phase: int):
    """VoiceActivityDetector::ProcessChunk (voice_activity_detector.cc:54).

    frame: (N, 160) int16-valued int32 at 16 kHz; phase: the static frame
    index mod 3, the probabilities update on phase 2. Returns (state,
    probabilities (N, 3), rms (N, 3), valid): zeros and False unless
    phase is 2."""
    state = state.replace(sa_buffer=torch.cat([state.sa_buffer[:, 160:],
                                               frame], 1))
    ap_state, features = extract_features(state.audio_proc, frame.to(F32),
                                          full=(phase == 2))
    state = state.replace(audio_proc=ap_state)
    if phase != 2:
        z = frame.new_zeros((frame.shape[0], 3), dtype=F32)
        return state, z, z, False

    # StandaloneVad::GetActivity over the 30 ms buffer at mode 3; on
    # silence the reference never calls it, so its state holds.
    silence = features["silence"]
    sa_state, activity = legacy_vad.process(state.standalone,
                                            state.sa_buffer, SAMPLE_RATE_HZ,
                                            mode=3)
    state = state.replace(standalone=tree_where(silence, state.standalone,
                                                sa_state))
    p0 = torch.where(activity == 0, 0.01, 0.5).to(F32)
    p = p0[:, None].expand(-1, 3)
    pv_state, p = pitch_based_voicing(state.pitch_vad, features, p)
    # Silence: a low probability, the pitch states untouched
    # (voice_activity_detector.cc:92-99).
    p = torch.where(silence[:, None], 0.01, p)
    state = state.replace(
        pitch_vad=tree_where(silence, state.pitch_vad, pv_state),
        last_probability=p[:, -1].contiguous())
    return state, p, features["rms"], True


class AnalyticsVad(nn.Module):
    """The VoiceActivityDetector at the 30 ms cadence; ``forward(state,
    frame, phase)`` takes (N, 160) int16-valued int32 frames."""

    def forward(self, state: VoiceActivityDetectorState, frame,
                phase: int):
        return process_chunk(state, frame, phase)
