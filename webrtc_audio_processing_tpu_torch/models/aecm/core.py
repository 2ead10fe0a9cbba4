"""AECM core: the fixed-point mobile echo canceller, on (N, ...) rows.

Port of ``webrtc_audio_processing_tpu/models/aecm/core.py`` (reference:
aecm/aecm_core.{h,cc}, aecm/aecm_core_c.cc, aecm/aecm_defines.h,
utility/delay_estimator{_wrapper}.cc): 64-sample partitions, the int16 FFT
with a dynamic Q domain (``ops/int_fft.py``), binary-spectrum delay
estimation, the NLMS channel update in Q(RESOLUTION_CHANNEL), the
Wiener-like NLP in Q14 and comfort noise. The JAX package writes one
canceller and batches it with ``vmap``; here each per-canceller scalar is
an (N,) tensor and each per-canceller vector an (N, k) one.

Bit for bit with the JAX package:
- int32 products and sums wrap in both (a sum is taken in int64 and
  wrapped, ``_sum32``); ``>>`` is arithmetic and every shift count is
  clamped into [0, 31] before use, where the JAX package clamps or where
  its select discards the lane;
- the JAX package's uint32 values (the binary far history, the comfort
  noise seed and the unsigned division ``DivU32U16``) are int64 here,
  masked to 32 bits (``ops/spl.py``'s ``_u32`` / ``_from_u32``);
- ``//`` floors where the JAX package floors, and ``spl.div_w32_w16``
  truncates where it truncates;
- the magnitude ``floor(sqrt(float32(re^2 + im^2)))`` is corrected to the
  exact integer square root by two integer steps, so it does not hang on
  the device's float32 square root;
- comfort noise draws its 64 ``WebRtcSpl_RandU`` values by a jump-ahead
  of the LCG (``s_k = A_k s + C_k mod 2^32``, tabled once) in place of the
  JAX package's 64-step scan.

The JAX package's ``fixed_delay`` and ``debug_taps`` arguments (the
conformance tool's taps) are not ported.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from webrtc_audio_processing_tpu_torch.ops import batch as batch_ops
from webrtc_audio_processing_tpu_torch.ops import int_fft, spl

I32 = torch.int32
I64 = torch.int64
_MASK32 = 0xFFFFFFFF

PART_LEN = 64
PART_LEN1 = 65
PART_LEN2 = 128
MAX_DELAY = 100
MAX_BUF_LEN = 64
FAR_ENERGY_MIN = 1025
FAR_ENERGY_DIFF = 929
ENERGY_DEV_TOL = 400
FAR_ENERGY_VAD_REGION = 230
MU_MIN, MU_MAX, MU_DIFF = 10, 1, 9
MIN_MSE_COUNT = 20
MIN_MSE_DIFF = 29
MSE_RESOLUTION = 5
RESOLUTION_CHANNEL16 = 12
RESOLUTION_CHANNEL32 = 28
CHANNEL_VAD = 16
RESOLUTION_SUPGAIN = 8
SUPGAIN_DEFAULT = 1 << RESOLUTION_SUPGAIN
SUPGAIN_ERROR_PARAM_A = 3072
SUPGAIN_ERROR_PARAM_B = 1536
SUPGAIN_ERROR_PARAM_D = SUPGAIN_DEFAULT
SUPGAIN_EPC_DT = 200
ENERGY_DEV_OFFSET = 0
ONE_Q14 = 1 << 14
NLP_COMP_LOW = 3277
NLP_COMP_HIGH = ONE_Q14
CONV_LEN = 512

# Binary delay estimator constants (delay_estimator.cc:26-35).
K_BAND_FIRST, K_BAND_LAST = 12, 43
K_SHIFTS_AT_ZERO = 13
K_SHIFTS_LINEAR_SLOPE = 3
K_PROB_OFFSET = 1024
K_PROB_LOWER_LIMIT = 8704
K_PROB_MIN_SPREAD = 2816
K_MAX_BIT_COUNTS_Q9 = 32 << 9

# WebRtcSpl_RandU (randomization_functions.c:84-104).
LCG_A = 69069
LCG_C = 1


def sup_gain_params(echo_mode: int):
    """Routing-mode suppression params (echo_control_mobile.cc:435-482):
    (default, A, D, diffAB, diffBD) as Python ints."""
    shift = {0: -3, 1: -2, 2: -1, 3: 0, 4: 1}[echo_mode]

    def s(v):
        return v << shift if shift >= 0 else v >> -shift

    a, b, d = map(s, (SUPGAIN_ERROR_PARAM_A, SUPGAIN_ERROR_PARAM_B,
                      SUPGAIN_ERROR_PARAM_D))
    return s(SUPGAIN_DEFAULT), a, d, a - b, b - d


# kSqrtHanning (aecm_core_c.cc:35-41). The legacy table is NOT
# round(16384*sin(pi*i/128)) — several entries are off by a few LSB from
# the analytic curve, so the literal values are required for bit-exactness.
SQRT_HANNING = np.array([
    0, 399, 798, 1196, 1594, 1990, 2386, 2780, 3172, 3562, 3951,
    4337, 4720, 5101, 5478, 5853, 6224, 6591, 6954, 7313, 7668, 8019,
    8364, 8705, 9040, 9370, 9695, 10013, 10326, 10633, 10933, 11227, 11514,
    11795, 12068, 12335, 12594, 12845, 13089, 13325, 13553, 13773, 13985,
    14189, 14384, 14571, 14749, 14918, 15079, 15231, 15373, 15506, 15631,
    15746, 15851, 15947, 16034, 16111, 16179, 16237, 16286, 16325, 16354,
    16373, 16384], np.int32)

# kCosTable/kSinTable (aecm_core.cc:60-130). Legacy tables: 175 of
# 360 entries differ by 1 LSB from round(8192*cos/sin) — literal
# values required for bit-exactness.
COS_TABLE = np.array([
    8192, 8190, 8187, 8180, 8172, 8160, 8147, 8130, 8112, 8091, 8067,
    8041, 8012, 7982, 7948, 7912, 7874, 7834, 7791, 7745, 7697, 7647,
    7595, 7540, 7483, 7424, 7362, 7299, 7233, 7164, 7094, 7021, 6947,
    6870, 6791, 6710, 6627, 6542, 6455, 6366, 6275, 6182, 6087, 5991,
    5892, 5792, 5690, 5586, 5481, 5374, 5265, 5155, 5043, 4930, 4815,
    4698, 4580, 4461, 4341, 4219, 4096, 3971, 3845, 3719, 3591, 3462,
    3331, 3200, 3068, 2935, 2801, 2667, 2531, 2395, 2258, 2120, 1981,
    1842, 1703, 1563, 1422, 1281, 1140, 998, 856, 713, 571, 428,
    285, 142, 0, -142, -285, -428, -571, -713, -856, -998, -1140,
    -1281, -1422, -1563, -1703, -1842, -1981, -2120, -2258, -2395, -2531, -2667,
    -2801, -2935, -3068, -3200, -3331, -3462, -3591, -3719, -3845, -3971, -4095,
    -4219, -4341, -4461, -4580, -4698, -4815, -4930, -5043, -5155, -5265, -5374,
    -5481, -5586, -5690, -5792, -5892, -5991, -6087, -6182, -6275, -6366, -6455,
    -6542, -6627, -6710, -6791, -6870, -6947, -7021, -7094, -7164, -7233, -7299,
    -7362, -7424, -7483, -7540, -7595, -7647, -7697, -7745, -7791, -7834, -7874,
    -7912, -7948, -7982, -8012, -8041, -8067, -8091, -8112, -8130, -8147, -8160,
    -8172, -8180, -8187, -8190, -8191, -8190, -8187, -8180, -8172, -8160, -8147,
    -8130, -8112, -8091, -8067, -8041, -8012, -7982, -7948, -7912, -7874, -7834,
    -7791, -7745, -7697, -7647, -7595, -7540, -7483, -7424, -7362, -7299, -7233,
    -7164, -7094, -7021, -6947, -6870, -6791, -6710, -6627, -6542, -6455, -6366,
    -6275, -6182, -6087, -5991, -5892, -5792, -5690, -5586, -5481, -5374, -5265,
    -5155, -5043, -4930, -4815, -4698, -4580, -4461, -4341, -4219, -4096, -3971,
    -3845, -3719, -3591, -3462, -3331, -3200, -3068, -2935, -2801, -2667, -2531,
    -2395, -2258, -2120, -1981, -1842, -1703, -1563, -1422, -1281, -1140, -998,
    -856, -713, -571, -428, -285, -142, 0, 142, 285, 428, 571,
    713, 856, 998, 1140, 1281, 1422, 1563, 1703, 1842, 1981, 2120,
    2258, 2395, 2531, 2667, 2801, 2935, 3068, 3200, 3331, 3462, 3591,
    3719, 3845, 3971, 4095, 4219, 4341, 4461, 4580, 4698, 4815, 4930,
    5043, 5155, 5265, 5374, 5481, 5586, 5690, 5792, 5892, 5991, 6087,
    6182, 6275, 6366, 6455, 6542, 6627, 6710, 6791, 6870, 6947, 7021,
    7094, 7164, 7233, 7299, 7362, 7424, 7483, 7540, 7595, 7647, 7697,
    7745, 7791, 7834, 7874, 7912, 7948, 7982, 8012, 8041, 8067, 8091,
    8112, 8130, 8147, 8160, 8172, 8180, 8187, 8190,
], np.int32)

SIN_TABLE = np.array([
    0, 142, 285, 428, 571, 713, 856, 998, 1140, 1281, 1422,
    1563, 1703, 1842, 1981, 2120, 2258, 2395, 2531, 2667, 2801, 2935,
    3068, 3200, 3331, 3462, 3591, 3719, 3845, 3971, 4095, 4219, 4341,
    4461, 4580, 4698, 4815, 4930, 5043, 5155, 5265, 5374, 5481, 5586,
    5690, 5792, 5892, 5991, 6087, 6182, 6275, 6366, 6455, 6542, 6627,
    6710, 6791, 6870, 6947, 7021, 7094, 7164, 7233, 7299, 7362, 7424,
    7483, 7540, 7595, 7647, 7697, 7745, 7791, 7834, 7874, 7912, 7948,
    7982, 8012, 8041, 8067, 8091, 8112, 8130, 8147, 8160, 8172, 8180,
    8187, 8190, 8191, 8190, 8187, 8180, 8172, 8160, 8147, 8130, 8112,
    8091, 8067, 8041, 8012, 7982, 7948, 7912, 7874, 7834, 7791, 7745,
    7697, 7647, 7595, 7540, 7483, 7424, 7362, 7299, 7233, 7164, 7094,
    7021, 6947, 6870, 6791, 6710, 6627, 6542, 6455, 6366, 6275, 6182,
    6087, 5991, 5892, 5792, 5690, 5586, 5481, 5374, 5265, 5155, 5043,
    4930, 4815, 4698, 4580, 4461, 4341, 4219, 4096, 3971, 3845, 3719,
    3591, 3462, 3331, 3200, 3068, 2935, 2801, 2667, 2531, 2395, 2258,
    2120, 1981, 1842, 1703, 1563, 1422, 1281, 1140, 998, 856, 713,
    571, 428, 285, 142, 0, -142, -285, -428, -571, -713, -856,
    -998, -1140, -1281, -1422, -1563, -1703, -1842, -1981, -2120, -2258, -2395,
    -2531, -2667, -2801, -2935, -3068, -3200, -3331, -3462, -3591, -3719, -3845,
    -3971, -4095, -4219, -4341, -4461, -4580, -4698, -4815, -4930, -5043, -5155,
    -5265, -5374, -5481, -5586, -5690, -5792, -5892, -5991, -6087, -6182, -6275,
    -6366, -6455, -6542, -6627, -6710, -6791, -6870, -6947, -7021, -7094, -7164,
    -7233, -7299, -7362, -7424, -7483, -7540, -7595, -7647, -7697, -7745, -7791,
    -7834, -7874, -7912, -7948, -7982, -8012, -8041, -8067, -8091, -8112, -8130,
    -8147, -8160, -8172, -8180, -8187, -8190, -8191, -8190, -8187, -8180, -8172,
    -8160, -8147, -8130, -8112, -8091, -8067, -8041, -8012, -7982, -7948, -7912,
    -7874, -7834, -7791, -7745, -7697, -7647, -7595, -7540, -7483, -7424, -7362,
    -7299, -7233, -7164, -7094, -7021, -6947, -6870, -6791, -6710, -6627, -6542,
    -6455, -6366, -6275, -6182, -6087, -5991, -5892, -5792, -5690, -5586, -5481,
    -5374, -5265, -5155, -5043, -4930, -4815, -4698, -4580, -4461, -4341, -4219,
    -4096, -3971, -3845, -3719, -3591, -3462, -3331, -3200, -3068, -2935, -2801,
    -2667, -2531, -2395, -2258, -2120, -1981, -1842, -1703, -1563, -1422, -1281,
    -1140, -998, -856, -713, -571, -428, -285, -142,
], np.int32)

CHANNEL_STORED_8K = np.array([
    2040, 1815, 1590, 1498, 1405, 1395, 1385, 1418, 1451, 1506, 1562,
    1644, 1726, 1804, 1882, 1918, 1953, 1982, 2010, 2025, 2040, 2034,
    2027, 2021, 2014, 1997, 1980, 1925, 1869, 1800, 1732, 1683, 1635,
    1604, 1572, 1545, 1517, 1481, 1444, 1405, 1367, 1331, 1294, 1270,
    1245, 1239, 1233, 1247, 1260, 1282, 1303, 1338, 1373, 1407, 1441,
    1470, 1499, 1524, 1549, 1565, 1582, 1601, 1621, 1649, 1676], np.int32)

CHANNEL_STORED_16K = np.array([
    2040, 1590, 1405, 1385, 1451, 1562, 1726, 1882, 1953, 2010, 2040,
    2027, 2014, 1980, 1869, 1732, 1635, 1572, 1517, 1444, 1367, 1294,
    1245, 1233, 1260, 1303, 1373, 1441, 1499, 1549, 1582, 1621, 1676,
    1741, 1802, 1861, 1921, 1983, 2040, 2102, 2170, 2265, 2375, 2515,
    2651, 2781, 2922, 3075, 3253, 3471, 3738, 3976, 4151, 4258, 4308,
    4288, 4270, 4253, 4237, 4179, 4086, 3947, 3757, 3484, 3153], np.int32)



def lcg_jump_tables(steps: int = PART_LEN):
    """(A_k, C_k) for k = 1..steps: k steps of the LCG from seed s give
    ``A_k * s + C_k mod 2^32`` (A_k = 69069^k, C_k = sum_{j<k} 69069^j)."""
    a, c = [], []
    ak, ck = 1, 0
    for _ in range(steps):
        ak, ck = (ak * LCG_A) & _MASK32, (ck * LCG_A + LCG_C) & _MASK32
        a.append(ak)
        c.append(ck)
    return tuple(a), tuple(c)


_LCG_A, _LCG_C = lcg_jump_tables()


def _mul_u32(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(a * s) mod 2^32 for int64 ``a``, ``s`` in [0, 2^32), by a 16-bit
    split of ``a`` (the full product would leave int64)."""
    lo = (a & 0xFFFF) * s
    hi = (((a >> 16) * s) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def lcg_draws(seed: torch.Tensor, steps: int = PART_LEN):
    """``steps`` WebRtcSpl_RandU draws from (N,) int64 seeds (uint32
    values): returns ((N, steps) int32 draws, (N,) int64 new seed), equal
    to ``steps`` steps of ``s = s * 69069 + 1``, each drawing
    ``(s >> 16) & 0x7FFF``."""
    dev = seed.device
    a = batch_ops.const(_LCG_A[:steps], I64, dev)
    c = batch_ops.const(_LCG_C[:steps], I64, dev)
    s = (_mul_u32(a, seed[:, None]) + c) & _MASK32
    return ((s >> 16) & 0x7FFF).to(I32), s[:, -1]


def _sum32(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """An int32 sum that wraps mod 2^32, as the JAX package's does."""
    return spl._from_u32(x.sum(dim, dtype=I64))


def _c(values, device, dtype=I32) -> torch.Tensor:
    return batch_ops.const(tuple(int(v) for v in values), dtype, device)


def _where(cond, a, b):
    return batch_ops.where(cond, a, b)


def _pick(cond: torch.Tensor, a: int, b: int) -> torch.Tensor:
    """int32 ``a`` where ``cond``, else ``b`` (torch.where of two Python
    ints would give int64)."""
    return b + cond.to(I32) * (a - b)


def _shl(v: torch.Tensor, s) -> torch.Tensor:
    return v << torch.clamp(s, 0, 31)


def _shr(v: torch.Tensor, s) -> torch.Tensor:
    return v >> torch.clamp(s, 0, 31)


def _shift_w32(v: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """WEBRTC_SPL_SHIFT_W32: left for s >= 0, arithmetic right for s < 0."""
    return torch.where(s >= 0, _shl(v, s), _shr(v, -s))


def _shift_u32(v: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """WEBRTC_SPL_SHIFT_W32 on an unsigned value: a logical right shift."""
    u = spl._u32(v)
    su = torch.clamp(torch.abs(s), max=31).to(I64)
    return spl._from_u32(torch.where(s >= 0, u << su, u >> su))


@dataclass
class BinaryDelayEstimatorState:
    """delay_estimator.{h,cc} with robust validation off (the AECM
    default); leaves (N, ...)."""

    far_threshold: torch.Tensor  # (N, 65) int32 mean spectra (Q15)
    far_threshold_init: torch.Tensor  # (N,) bool
    near_threshold: torch.Tensor  # (N, 65) int32
    near_threshold_init: torch.Tensor  # (N,) bool
    binary_far_history: torch.Tensor  # (N, 100) int64, uint32 values
    far_bit_counts: torch.Tensor  # (N, 100) int32
    mean_bit_counts: torch.Tensor  # (N, 100) int32 Q9
    minimum_probability: torch.Tensor  # (N,) int32
    last_delay_probability: torch.Tensor  # (N,) int32
    last_delay: torch.Tensor  # (N,) int32

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def init_delay_estimator(n: int, device) -> BinaryDelayEstimatorState:
    def full(shape, value, dtype=I32):
        return torch.full(shape, value, dtype=dtype, device=device)

    return BinaryDelayEstimatorState(
        far_threshold=full((n, PART_LEN1), 0),
        far_threshold_init=full((n,), False, torch.bool),
        near_threshold=full((n, PART_LEN1), 0),
        near_threshold_init=full((n,), False, torch.bool),
        binary_far_history=full((n, MAX_DELAY), 0, I64),
        far_bit_counts=full((n, MAX_DELAY), 0),
        mean_bit_counts=full((n, MAX_DELAY), 20 << 9),
        minimum_probability=full((n,), K_MAX_BIT_COUNTS_Q9),
        last_delay_probability=full((n,), K_MAX_BIT_COUNTS_Q9),
        last_delay=full((n,), -2),
    )


def _binary_spectrum(spectrum, threshold, initialized, q_domain):
    """BinarySpectrumFix (delay_estimator_wrapper.cc:44-71) on (N, 65)
    spectra; returns ((N,) int64 bits, threshold, initialized)."""
    lo, hi = K_BAND_FIRST, K_BAND_LAST + 1
    band = spectrum[:, lo:hi]
    spec_q15 = band << (15 - q_domain)[:, None]
    old = threshold[:, lo:hi]
    init_thr = torch.where(band > 0, spec_q15 >> 1, old)
    any_pos = (band > 0).any(1)
    thr_bands = _where(initialized, old, init_thr)
    initialized = initialized | any_pos
    # MeanEstimatorFix with factor 6 (toward-zero shift of the diff).
    diff = spec_q15 - thr_bands
    thr_bands = thr_bands + torch.where(diff < 0, -((-diff) >> 6), diff >> 6)
    threshold = torch.cat([threshold[:, :lo], thr_bands, threshold[:, hi:]],
                          1)
    weights = _c(range(hi - lo), spectrum.device, I64)
    bits = ((spec_q15 > thr_bands).to(I64) << weights).sum(1)
    return bits, threshold, initialized


def bit_count(x: torch.Tensor) -> torch.Tensor:
    """Population count of uint32 values held in int64 (the product's
    wrap mod 2^32 kept by the mask)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & _MASK32) >> 24).to(I32)


def delay_estimator_process(state: BinaryDelayEstimatorState, far_spectrum,
                            far_q, near_spectrum, near_q):
    """AddFarSpectrumFix + DelayEstimatorProcessFix (delay_estimator.cc:
    380-520 and :525-640, robust validation off) on N rows. Returns
    (state, last_delay (N,))."""
    far_bits, far_thr, far_init = _binary_spectrum(
        far_spectrum, state.far_threshold, state.far_threshold_init, far_q)
    history = torch.cat([far_bits[:, None],
                         state.binary_far_history[:, :-1]], 1)
    far_counts = torch.cat([bit_count(far_bits)[:, None],
                            state.far_bit_counts[:, :-1]], 1)
    near_bits, near_thr, near_init = _binary_spectrum(
        near_spectrum, state.near_threshold, state.near_threshold_init,
        near_q)

    bc_q9 = bit_count(near_bits[:, None] ^ history) << 9  # (N, 100)
    shifts = torch.clamp(
        K_SHIFTS_AT_ZERO - ((K_SHIFTS_LINEAR_SLOPE * far_counts) >> 4),
        min=0)
    diff = bc_q9 - state.mean_bit_counts
    step = torch.where(diff < 0, -((-diff) >> shifts), diff >> shifts)
    mean_bc = torch.where(far_counts > 0, state.mean_bit_counts + step,
                          state.mean_bit_counts)

    best = torch.argmin(mean_bc, 1).to(I32)
    value_best = mean_bc.amin(1)
    valley = mean_bc.amax(1) - value_best

    min_prob = state.minimum_probability
    thr = torch.clamp(value_best + K_PROB_OFFSET, min=K_PROB_LOWER_LIMIT)
    min_prob = torch.where(
        (min_prob > K_PROB_LOWER_LIMIT) & (valley > K_PROB_MIN_SPREAD),
        torch.minimum(min_prob, thr), min_prob)
    last_prob = state.last_delay_probability + 1
    valid = (valley > K_PROB_OFFSET) & ((value_best < min_prob)
                                        | (value_best < last_prob))
    take = (far_counts > 0).any(1) & valid
    last_delay = torch.where(take, best, state.last_delay)
    last_prob = torch.where(take, torch.minimum(value_best, last_prob),
                            last_prob)
    return state.replace(
        far_threshold=far_thr, far_threshold_init=far_init,
        near_threshold=near_thr, near_threshold_init=near_init,
        binary_far_history=history, far_bit_counts=far_counts,
        mean_bit_counts=mean_bc, minimum_probability=min_prob,
        last_delay_probability=last_prob, last_delay=last_delay,
    ), last_delay


@dataclass
class AecmCoreState:
    """AecmCore (aecm_core.h:71-180); leaves (N, ...), int32 unless
    noted."""

    xbuf: torch.Tensor  # (N, 128) far history (int16 values)
    dbuf_noisy: torch.Tensor  # (N, 128)
    outbuf: torch.Tensor  # (N, 64)
    dfa_noisy_q: torch.Tensor  # (N,)
    dfa_noisy_q_old: torch.Tensor
    far_history: torch.Tensor  # (N, 100, 65)
    far_q_domains: torch.Tensor  # (N, 100)
    far_history_pos: torch.Tensor  # (N,)
    delay_estimator: BinaryDelayEstimatorState
    channel_stored: torch.Tensor  # (N, 65) (int16 values)
    channel_adapt16: torch.Tensor  # (N, 65)
    channel_adapt32: torch.Tensor  # (N, 65)
    near_log_energy: torch.Tensor  # (N, 64)
    echo_adapt_log_energy: torch.Tensor  # (N, 64)
    echo_stored_log_energy: torch.Tensor  # (N, 64)
    far_log_energy: torch.Tensor  # (N,)
    far_energy_min: torch.Tensor
    far_energy_max: torch.Tensor
    far_energy_maxmin: torch.Tensor
    far_energy_vad: torch.Tensor
    far_energy_mse: torch.Tensor
    current_vad_value: torch.Tensor
    vad_update_count: torch.Tensor
    first_vad: torch.Tensor  # (N,) bool
    mse_adapt_old: torch.Tensor
    mse_stored_old: torch.Tensor
    mse_threshold: torch.Tensor
    mse_channel_count: torch.Tensor
    startup_state: torch.Tensor
    tot_count: torch.Tensor
    sup_gain: torch.Tensor
    sup_gain_old: torch.Tensor
    echo_filt: torch.Tensor  # (N, 65)
    near_filt: torch.Tensor  # (N, 65) (int16 values)
    noise_est: torch.Tensor  # (N, 65)
    noise_est_too_low: torch.Tensor  # (N, 65)
    noise_est_too_high: torch.Tensor  # (N, 65)
    noise_est_ctr: torch.Tensor  # (N,)
    seed: torch.Tensor  # (N,) int64, uint32 values

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def initial_noise_estimate() -> np.ndarray:
    """The pink-ish initial noise estimate (aecm_core.cc InitCore)."""
    noise = np.zeros(PART_LEN1, np.int64)
    tmp32 = PART_LEN1 * PART_LEN1
    tmp16 = PART_LEN1
    for i in range((PART_LEN1 >> 1) - 1):
        noise[i] = tmp32 << 8
        tmp16 -= 1
        tmp32 -= (tmp16 << 1) + 1
    noise[(PART_LEN1 >> 1) - 1:] = tmp32 << 8
    return noise.astype(np.int32)


def init_core(sample_rate_hz: int, echo_mode: int, n: int,
              device) -> AecmCoreState:
    stored = (CHANNEL_STORED_16K if sample_rate_hz >= 16000
              else CHANNEL_STORED_8K)
    sup_default = sup_gain_params(echo_mode)[0]

    def full(shape, value, dtype=I32):
        return torch.full(shape, value, dtype=dtype, device=device)

    def rows(values, dtype=I32):
        return torch.as_tensor(np.asarray(values), dtype=dtype).to(
            device).expand(n, len(values)).clone()

    return AecmCoreState(
        xbuf=full((n, PART_LEN2), 0),
        dbuf_noisy=full((n, PART_LEN2), 0),
        outbuf=full((n, PART_LEN), 0),
        dfa_noisy_q=full((n,), 0),
        dfa_noisy_q_old=full((n,), 0),
        far_history=full((n, MAX_DELAY, PART_LEN1), 0),
        far_q_domains=full((n, MAX_DELAY), 0),
        # C inits to MAX_DELAY and wraps to 0 on the first increment
        # (aecm_core.cc:142); with mod arithmetic that is MAX_DELAY - 1.
        far_history_pos=full((n,), MAX_DELAY - 1),
        delay_estimator=init_delay_estimator(n, device),
        channel_stored=rows(stored),
        channel_adapt16=rows(stored),
        channel_adapt32=rows(stored.astype(np.int64) << 16),
        near_log_energy=full((n, MAX_BUF_LEN), 0),
        echo_adapt_log_energy=full((n, MAX_BUF_LEN), 0),
        echo_stored_log_energy=full((n, MAX_BUF_LEN), 0),
        far_log_energy=full((n,), 0),
        far_energy_min=full((n,), 32767),
        far_energy_max=full((n,), -32768),
        far_energy_maxmin=full((n,), 0),
        far_energy_vad=full((n,), FAR_ENERGY_MIN),
        far_energy_mse=full((n,), 0),
        current_vad_value=full((n,), 0),
        vad_update_count=full((n,), 0),
        first_vad=full((n,), True, torch.bool),
        mse_adapt_old=full((n,), 1000),
        mse_stored_old=full((n,), 1000),
        mse_threshold=full((n,), 0x7FFFFFFF),
        mse_channel_count=full((n,), 0),
        startup_state=full((n,), 0),
        tot_count=full((n,), 0),
        sup_gain=full((n,), sup_default),
        sup_gain_old=full((n,), sup_default),
        echo_filt=full((n, PART_LEN1), 0),
        near_filt=full((n, PART_LEN1), 0),
        noise_est=rows(initial_noise_estimate()),
        noise_est_too_low=full((n, PART_LEN1), 0),
        noise_est_too_high=full((n, PART_LEN1), 0),
        noise_est_ctr=full((n,), 0),
        seed=full((n,), 666, I64),
    )


def norm_w16(x: torch.Tensor) -> torch.Tensor:
    """WebRtcSpl_NormW16 for int16-valued int32."""
    return torch.clamp(spl.norm_w32(x << 16), 0, 15)


def log_of_energy_q8(energy: torch.Tensor, q_domain) -> torch.Tensor:
    """LogOfEnergyInQ8 (aecm_core.cc:70-82). ``energy`` carries uint32 bit
    patterns in int32 (the C sums wrap mod 2^32), so the zero test is
    ``!= 0``."""
    k_low = 7 << 7  # kLogLowValue = PART_LEN_SHIFT << 7
    zeros = spl.norm_u32(energy)
    frac = (spl.shl_u32(energy, zeros) & 0x7FFFFFFF) >> 23
    val = k_low + (((31 - zeros) << 8) + frac - (q_domain << 8))
    return torch.where(energy != 0, val, k_low).to(I32)


def floor_sqrt(sq: torch.Tensor) -> torch.Tensor:
    """floor(sqrt(sq)) for int64 ``sq`` in [0, 2^31], as the JAX package
    computes it: the float32 estimate ``floor(sqrt(float32(sq)))``, then
    one integer step down and one up, which land on the exact floor square
    root."""
    s = torch.floor(torch.sqrt(sq.to(torch.float32))).to(I64)
    s = torch.where(s * s > sq, s - 1, s)
    return torch.where((s + 1) * (s + 1) <= sq, s + 1, s)


def magnitude(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """SqrtFloor(re^2 + im^2) of int16-valued parts (at most 2^31)."""
    return floor_sqrt(re.to(I64) * re + im.to(I64) * im).to(I32)


def time_to_frequency(buf: torch.Tensor):
    """TimeToFrequencyDomain (aecm_core_c.cc:204-296) on (N, 128) int32.
    Returns (re, im, magnitude (N, 65), its sum (N,), q scaling (N,))."""
    dev = buf.device
    scaling = norm_w16(buf.abs().amax(1))
    scaled = buf << scaling[:, None]
    w = _c(np.concatenate([SQRT_HANNING[:PART_LEN],
                           SQRT_HANNING[PART_LEN:0:-1]]), dev)
    windowed = int_fft.wrap16((scaled * w) >> 14)
    # The forward int16 FFT, then WindowAndFFT's conjugate
    # (aecm_core_c.cc:196-199) with bins 0 and 64 imaginary-free.
    re, im = int_fft.real_forward_fft_i16(windowed)
    edge = np.ones(PART_LEN1, np.int32)
    edge[[0, PART_LEN]] = 0
    im = int_fft.wrap16(-im) * _c(edge, dev)
    mag = magnitude(re, im)
    mag = torch.cat([re[:, :1].abs(), mag[:, 1:PART_LEN],
                     re[:, PART_LEN:].abs()], 1)
    return re, im, mag, mag.sum(1, dtype=I32), scaling


def _asym(old, new, pos_shift, neg_shift):
    out = torch.where(old > new, old - ((old - new) >> neg_shift),
                      old + ((new - old) >> pos_shift))
    return torch.where((old == 32767) | (old == -32768), new, out)


def _comfort_noise(state: AecmCoreState, dfa, dfa_q, hnl, efw_re, efw_im):
    """ComfortNoise (aecm_core_c.cc:44-172): the noise estimate's update,
    then noise of random phase added to the spectrum. Returns (noise_est,
    too_low, too_high, seed, efw_re, efw_im)."""
    dev = dfa.device
    noise_est = state.noise_est
    too_low, too_high = state.noise_est_too_low, state.noise_est_too_high
    shift_noise = torch.clamp(15 - dfa_q, 0, 15)[:, None]  # kNoiseEstQDomain
    min_track = _pick(state.noise_est_ctr < 100, 6, 9)[:, None]
    out_l = dfa << shift_noise
    below = out_l < noise_est
    small = noise_est < (1 << min_track)
    # Below the estimate: track the minimum.
    inc_high = torch.where(below & small, too_high + 1,
                           torch.where(below, too_high, 0))
    dec = below & small & (inc_high >= 5)
    noise_dn = torch.where(small, noise_est - dec.to(I32),
                           noise_est - ((noise_est - out_l) >> min_track))
    inc_high = torch.where(dec, 0, inc_high)
    # At or above it: ramp slowly upwards. tooLowCtr counts only in the
    # small-value branch, resets on a bump or below, else is kept
    # (aecm_core_c.cc:118-135).
    tiny = (noise_est >> 11) <= 0
    low_inc = torch.where(~below & tiny, too_low + 1, too_low)
    bump = ~below & tiny & (low_inc >= 5)
    noise_up = torch.where(
        (noise_est >> 19) > 0, (noise_est >> 11) * 2049,
        torch.where(~tiny, (noise_est * 2049) >> 11,
                    torch.where(bump, noise_est + (noise_est >> 9) + 1,
                                noise_est)))
    low_inc = torch.where(bump, 0, low_inc)
    too_low = torch.where(below, 0, low_inc)
    too_high = torch.where(below, inc_high, 0)
    noise_est = torch.where(below, noise_dn, noise_up)

    # Read back in the near-end domain, the saturation written back.
    read = noise_est >> shift_noise
    noise_est = torch.where(read > 32767, 32767 << shift_noise, noise_est)
    noise_r = ((ONE_Q14 - hnl) * torch.clamp(read, max=32767)) >> 14

    rnd, seed = lcg_draws(state.seed)
    idx = ((359 * rnd) >> 15).to(I64)
    cos = _c(COS_TABLE, dev)[idx]
    sin = _c(SIN_TABLE, dev)[idx]
    zero = torch.zeros_like(noise_r[:, :1])
    u_re = torch.cat([zero, (noise_r[:, 1:] * cos) >> 13], 1)
    u_im = torch.cat([zero, ((-noise_r[:, 1:PART_LEN]) * sin[:, :-1]) >> 13,
                      zero], 1)
    efw_re = torch.clamp(efw_re + u_re, -32768, 32767)
    efw_im = torch.clamp(efw_im + u_im, -32768, 32767)
    return noise_est, too_low, too_high, seed, efw_re, efw_im


def process_block(state: AecmCoreState, farend: torch.Tensor,
                  nearend: torch.Tensor, mult: int, echo_mode: int = 3,
                  nlp: bool = True, cng: bool = True):
    """WebRtcAecm_ProcessBlock (aecm_core_c.cc:306-580) on N rows.

    farend, nearend: (N, 64) int32, int16-valued blocks. Returns (state,
    output (N, 64) int32)."""
    dev = farend.device
    startup = torch.where(
        state.startup_state < 2,
        (state.tot_count >= CONV_LEN).to(I32)
        + (state.tot_count >= 2 * CONV_LEN).to(I32),
        state.startup_state)

    xbuf = torch.cat([state.xbuf[:, PART_LEN:], farend], 1)
    dbuf = torch.cat([state.dbuf_noisy[:, PART_LEN:], nearend], 1)
    _, _, xfa, _, far_q = time_to_frequency(xbuf)
    dre, dim, dfa, dfa_sum, near_q = time_to_frequency(dbuf)
    dfa_q_old = state.dfa_noisy_q
    dfa_q = near_q

    # Far history and the delay estimate (aecm_core.cc:138-190).
    pos = torch.remainder(state.far_history_pos + 1, MAX_DELAY)
    pos_l = pos.to(I64)[:, None]
    far_history = state.far_history.scatter(
        1, pos_l[:, :, None].expand(-1, 1, PART_LEN1), xfa[:, None])
    far_q_domains = state.far_q_domains.scatter(1, pos_l, far_q[:, None])
    de_state, delay = delay_estimator_process(
        state.delay_estimator, xfa, far_q, dfa, near_q)
    delay = torch.where(delay == -2, 0, delay)
    buffer_pos = torch.remainder(pos - delay, MAX_DELAY)
    far_spectrum = batch_ops.take(far_history, buffer_pos)  # (N, 65)
    x_q = batch_ops.take(far_q_domains, buffer_pos)  # (N,)

    # CalcEnergies (aecm_core.cc:657-768).
    near_log = torch.cat([log_of_energy_q8(dfa_sum, dfa_q)[:, None],
                          state.near_log_energy[:, :-1]], 1)
    echo_est = state.channel_stored * far_spectrum
    far_energy = _sum32(far_spectrum)
    echo_adapt_e = _sum32(state.channel_adapt16 * far_spectrum)
    echo_stored_e = _sum32(echo_est)
    far_log = log_of_energy_q8(far_energy, x_q)
    echo_adapt_log = torch.cat([
        log_of_energy_q8(echo_adapt_e, RESOLUTION_CHANNEL16 + x_q)[:, None],
        state.echo_adapt_log_energy[:, :-1]], 1)
    echo_stored_log = torch.cat([
        log_of_energy_q8(echo_stored_e, RESOLUTION_CHANNEL16 + x_q)[:, None],
        state.echo_stored_log_energy[:, :-1]], 1)

    active = far_log > FAR_ENERGY_MIN
    in_startup = startup == 0
    inc_max = _pick(in_startup, 2, 4)
    dec_min = _pick(in_startup, 2, 3)
    inc_min = _pick(in_startup, 8, 11)
    e_min = torch.where(active, _asym(state.far_energy_min, far_log,
                                      inc_min, dec_min),
                        state.far_energy_min)
    e_max = torch.where(active, _asym(state.far_energy_max, far_log,
                                      inc_max, 11),
                        state.far_energy_max)
    e_maxmin = torch.where(active, e_max - e_min, state.far_energy_maxmin)
    t16 = torch.clamp(2560 - e_min, min=0)
    t16 = torch.where(t16 > 0, (t16 * FAR_ENERGY_VAD_REGION) >> 9, 0)
    t16 = t16 + FAR_ENERGY_VAD_REGION
    set_vad = in_startup | (state.vad_update_count > 1024)
    vad_track = state.far_energy_vad > far_log
    e_vad = torch.where(
        active,
        torch.where(set_vad, e_min + t16,
                    torch.where(vad_track, state.far_energy_vad + (
                        (far_log + t16 - state.far_energy_vad) >> 6),
                                state.far_energy_vad)),
        state.far_energy_vad)
    vad_count = torch.where(
        active & ~set_vad,
        torch.where(vad_track, 0, state.vad_update_count + 1),
        state.vad_update_count)
    e_mse = torch.where(active, e_vad + (1 << 8), state.far_energy_mse)

    # The VAD keeps its value when the far energy is above the threshold
    # but neither in startup nor showing speech dynamics (aecm_core.cc:741).
    vad_value = torch.where(
        far_log > e_vad,
        torch.where(in_startup | (e_maxmin > FAR_ENERGY_DIFF), 1,
                    state.current_vad_value),
        0).to(I32)
    # The first VAD's channel adjustment.
    first_trip = (vad_value == 1) & state.first_vad
    adjust = first_trip & (echo_adapt_log[:, 0] > near_log[:, 0])
    channel_adapt16 = _where(adjust, state.channel_adapt16 >> 3,
                             state.channel_adapt16)
    echo_adapt_log = torch.cat([
        echo_adapt_log[:, :1] - _pick(adjust, 3 << 8, 0)[:, None],
        echo_adapt_log[:, 1:]], 1)
    first_vad = state.first_vad & ~(first_trip & ~adjust)

    # CalcStepSize (aecm_core.cc:780-806).
    mu_ramp = torch.clamp(MU_MIN - 1 - spl.div_w32_w16(
        (far_log - e_min) * MU_DIFF, torch.clamp(e_maxmin, min=1)),
        min=MU_MAX)
    mu = torch.where(
        vad_value == 0, 0,
        torch.where(startup > 0,
                    torch.where(e_min >= e_max, MU_MIN, mu_ramp),
                    MU_MAX)).to(I32)
    tot_count = state.tot_count + 1

    # UpdateChannel (aecm_core.cc:823-1011): NLMS in split Q domains.
    ch32 = state.channel_adapt32
    zeros_ch = spl.norm_u32(ch32)
    zeros_far = spl.norm_u32(far_spectrum)
    no_shift = zeros_ch + zeros_far > 31
    shift_ch_far = torch.where(no_shift, 0, 32 - zeros_ch - zeros_far)
    prod = torch.where(no_shift, ch32 * far_spectrum,  # uint32 wrap pattern
                       _shr(ch32, shift_ch_far) * far_spectrum)
    zeros_num = spl.norm_u32(prod)
    zeros_dfa = torch.where(dfa > 0, spl.norm_u32(dfa), 32)
    dq, xq = dfa_q[:, None], x_q[:, None]
    t16a = zeros_dfa - 2 + dq - RESOLUTION_CHANNEL32 - xq + shift_ch_far
    use_a = zeros_num > t16a + 1
    xfa_q = torch.where(use_a, t16a, zeros_num - 2)
    dfa_q_shift = torch.where(
        use_a, zeros_dfa - 2,
        RESOLUTION_CHANNEL32 + xq - dq - shift_ch_far + (zeros_num - 2))
    err = _shift_u32(dfa, dfa_q_shift) - _shift_u32(prod, xfa_q)
    zeros_err = spl.norm_w32(err)
    can_update = (err != 0) & (far_spectrum > (CHANNEL_VAD << xq))
    no_shift2 = zeros_err + zeros_far > 31
    shift_num = torch.where(no_shift2, 0, 32 - (zeros_err + zeros_far))
    step = torch.where(err > 0, _shr(err, shift_num) * far_spectrum,
                       -(_shr(-err, shift_num) * far_spectrum))
    step = spl.div_w32_w16(step, _c(range(1, PART_LEN1 + 1), dev))
    shift2 = (shift_num + shift_ch_far - xfa_q - mu[:, None]
              - ((30 - zeros_far) << 1))
    overflow = spl.norm_w32(step) < shift2
    step = torch.where(overflow, spl.WORD32_MAX, _shift_w32(step, shift2))
    # WebRtcSpl_AddSatW32 by the same-sign wrap test, as the JAX package.
    wrap_sum = ch32 + step
    new_ch32 = torch.where(
        (ch32 > 0) & (step > 0) & (wrap_sum < 0), spl.WORD32_MAX,
        torch.where((ch32 < 0) & (step < 0) & (wrap_sum >= 0),
                    spl.WORD32_MIN, wrap_sum))
    new_ch32 = torch.clamp(new_ch32, min=0)
    do_upd = (mu > 0)[:, None] & can_update
    ch32 = torch.where(do_upd, new_ch32, ch32)
    channel_adapt16 = torch.where(do_upd, ch32 >> 16, channel_adapt16)

    # Store and reset decisions (aecm_core.cc:955-1010); the MSE counter
    # runs only outside the startup store branch.
    store_startup = in_startup & (vad_value == 1)
    mse_count = torch.where(
        store_startup, state.mse_channel_count,
        torch.where(far_log < e_mse, 0, state.mse_channel_count + 1))
    do_mse = ~store_startup & (mse_count >= MIN_MSE_COUNT + 10)
    near20 = near_log[:, :MIN_MSE_COUNT]
    mse_stored = (echo_stored_log[:, :MIN_MSE_COUNT] - near20).abs().sum(
        1, dtype=I32)
    mse_adapt = (echo_adapt_log[:, :MIN_MSE_COUNT] - near20).abs().sum(
        1, dtype=I32)
    reset_adapt = do_mse & (
        ((mse_stored << MSE_RESOLUTION) < (MIN_MSE_DIFF * mse_adapt))
        & ((state.mse_stored_old << MSE_RESOLUTION)
           < (MIN_MSE_DIFF * state.mse_adapt_old)))
    store_adapt = do_mse & ~reset_adapt & (
        ((MIN_MSE_DIFF * mse_stored) > (mse_adapt << MSE_RESOLUTION))
        & (mse_adapt < state.mse_threshold)
        & (state.mse_adapt_old < state.mse_threshold))
    store = store_startup | store_adapt
    channel_stored = _where(store, channel_adapt16, state.channel_stored)
    echo_est = _where(store, channel_stored * far_spectrum, echo_est)
    channel_adapt16 = _where(reset_adapt, channel_stored, channel_adapt16)
    ch32 = _where(reset_adapt, channel_stored << 16, ch32)
    mse_threshold = torch.where(
        store_adapt,
        torch.where(state.mse_threshold == 0x7FFFFFFF,
                    mse_adapt + state.mse_adapt_old,
                    state.mse_threshold + (((mse_adapt - state.mse_threshold
                                             * 5 // 8) * 205) >> 8)),
        state.mse_threshold)
    mse_stored_old = torch.where(do_mse, mse_stored, state.mse_stored_old)
    mse_adapt_old = torch.where(do_mse, mse_adapt, state.mse_adapt_old)
    mse_count = torch.where(do_mse, 0, mse_count)

    # CalcSuppressionGain (aecm_core.cc:1014-1076).
    _, par_a, par_d, diff_ab, diff_bd = sup_gain_params(echo_mode)
    dE = torch.abs(near_log[:, 0] - echo_stored_log[:, 0]
                   - ENERGY_DEV_OFFSET)
    sup = torch.where(
        vad_value == 0, 0,
        torch.where(
            dE < ENERGY_DEV_TOL,
            torch.where(
                dE < SUPGAIN_EPC_DT,
                par_a - spl.div_w32_w16(
                    diff_ab * dE + (SUPGAIN_EPC_DT >> 1), SUPGAIN_EPC_DT),
                par_d + spl.div_w32_w16(
                    diff_bd * (ENERGY_DEV_TOL - dE)
                    + ((ENERGY_DEV_TOL - SUPGAIN_EPC_DT) >> 1),
                    ENERGY_DEV_TOL - SUPGAIN_EPC_DT)),
            par_d)).to(I32)
    hold = torch.maximum(sup, state.sup_gain_old)
    sup_gain = state.sup_gain + ((hold - state.sup_gain) >> 4)

    # The Wiener-like NLP gain (aecm_core_c.cc:380-478). (int64{diff} * 50)
    # >> 8 in two limbs, exact in two's complement, as the JAX package.
    ef_diff = echo_est - state.echo_filt
    echo_filt = state.echo_filt + ((ef_diff >> 8) * 50
                                   + (((ef_diff & 255) * 50) >> 8))
    zeros32 = spl.norm_w32(echo_filt) + 1
    zeros16 = (norm_w16(sup_gain) + 1)[:, None]
    sg = sup_gain[:, None]
    fits = zeros32 + zeros16 > 16
    t = 17 - zeros32 - zeros16
    echo_gained = torch.where(
        fits, echo_filt * sg,
        torch.where(zeros32 > t, echo_filt * _shr(sg, t),
                    _shr(echo_filt, t) * sg))
    res_diff = (14 - RESOLUTION_CHANNEL16 - RESOLUTION_SUPGAIN + dq - xq
                + torch.where(fits, 0, t))

    # The near-end filter's smoothing in matched Q domains.
    near_filt0 = state.near_filt
    zeros16n = norm_w16(near_filt0)
    q_diff = (dfa_q - dfa_q_old)[:, None]
    use_shiftup = (zeros16n < q_diff) & (near_filt0 != 0)
    nf_scaled = torch.where(use_shiftup, near_filt0 << zeros16n,
                            _shift_w32(near_filt0, q_diff))
    qd = torch.where(use_shiftup, zeros16n - q_diff, 0)
    dfa_cmp = torch.where(use_shiftup, _shr(dfa, -qd), dfa)
    nf_new = nf_scaled + ((dfa_cmp - nf_scaled) >> 4)
    # The reference's saturation test is `tmp16no2 & (-qDomainDiff >
    # zeros16)`, a bitwise AND with a bool: it fires on odd values only
    # (aecm_core_c.cc:560-566), reproduced as the JAX package does.
    sat_nf = ((nf_new & 1) != 0) & (-qd > norm_w16(nf_new))
    shifted_nf = torch.where(qd < 0, nf_new << torch.clamp(-qd, 0, 15),
                             nf_new >> torch.clamp(qd, 0, 15))
    # nearFilt is an int16_t in C: the narrowing store.
    near_filt = torch.where(sat_nf, 32767, int_fft.wrap16(shifted_nf))

    # DivU32U16, unsigned: echoEst32Gained can carry uint32 bit patterns
    # (aecm_core_c.cc:577-583).
    num_u = (spl._u32(echo_gained) + spl._u32(near_filt >> 1)) & _MASK32
    denom = torch.clamp(near_filt, min=1).to(I64)
    ratio = _shift_u32(spl._from_u32(num_u // denom), res_diff)
    hnl = torch.where(
        echo_gained == 0, ONE_Q14,
        torch.where(near_filt == 0, 0,
                    torch.clamp(ONE_Q14 - ratio, 0, ONE_Q14))).to(I32)

    # numPosCoef counts the Wiener-stage gains, before the wideband
    # squaring and the NLP (aecm_core_c.cc:598-600).
    num_pos = (hnl != 0).sum(1)
    if mult == 2:
        hnl = (hnl * hnl) >> 14
        avg = (hnl[:, 4:25].sum(1, dtype=I32) // 21)[:, None]
        upper = _c([0] * 24 + [1] * (PART_LEN1 - 24), dev).bool()
        hnl = torch.where(upper & (hnl > avg), avg, hnl)
    if nlp:
        hnl = torch.where(hnl > NLP_COMP_HIGH, ONE_Q14,
                          torch.where(hnl < NLP_COMP_LOW, 0, hnl))
        nlp_gain = _pick(num_pos < 3, 0, ONE_Q14)[:, None]
        hnl = torch.where((hnl == ONE_Q14) & (nlp_gain == ONE_Q14), ONE_Q14,
                          (hnl * nlp_gain) >> 14)
    efw_re = (dre * hnl + (1 << 13)) >> 14
    efw_im = (dim * hnl + (1 << 13)) >> 14

    noise_est, too_low = state.noise_est, state.noise_est_too_low
    too_high, seed = state.noise_est_too_high, state.seed
    if cng:
        noise_est, too_low, too_high, seed, efw_re, efw_im = _comfort_noise(
            state, dfa, dfa_q, hnl, efw_re, efw_im)
    noise_ctr = torch.clamp(state.noise_est_ctr + 1, max=100)

    # InverseFFTAndWindow (aecm_core_c.cc:202-246): the synthesis input is
    # the conjugate of efw; the int IFFT returns its renormalization count
    # outCFFT, and the output is shifted by outCFFT - dfaCleanQDomain
    # before the overlap-add.
    ifft, out_cfft = int_fft.real_inverse_fft_i16(efw_re,
                                                  int_fft.wrap16(-efw_im))
    win = _c(SQRT_HANNING[:PART_LEN], dev)
    win_back = _c(SQRT_HANNING[PART_LEN:0:-1], dev)
    first = int_fft.wrap16((ifft[:, :PART_LEN] * win + 8192) >> 14)
    qshift = (out_cfft - dfa_q)[:, None]  # dfaCleanQDomain == dfaNoisyQ
    out = torch.clamp(_shift_w32(first, qshift) + state.outbuf,
                      -32768, 32767)
    second = (ifft[:, PART_LEN:] * win_back) >> 14
    outbuf = torch.clamp(_shift_w32(second, qshift), -32768, 32767)

    return state.replace(
        xbuf=xbuf, dbuf_noisy=dbuf, outbuf=outbuf, dfa_noisy_q=dfa_q,
        dfa_noisy_q_old=dfa_q_old, far_history=far_history,
        far_q_domains=far_q_domains, far_history_pos=pos,
        delay_estimator=de_state, channel_stored=channel_stored,
        channel_adapt16=channel_adapt16, channel_adapt32=ch32,
        near_log_energy=near_log, echo_adapt_log_energy=echo_adapt_log,
        echo_stored_log_energy=echo_stored_log, far_log_energy=far_log,
        far_energy_min=e_min, far_energy_max=e_max,
        far_energy_maxmin=e_maxmin, far_energy_vad=e_vad,
        far_energy_mse=e_mse, current_vad_value=vad_value,
        vad_update_count=vad_count, first_vad=first_vad,
        mse_adapt_old=mse_adapt_old, mse_stored_old=mse_stored_old,
        mse_threshold=mse_threshold, mse_channel_count=mse_count,
        startup_state=startup, tot_count=tot_count, sup_gain=sup_gain,
        sup_gain_old=sup, echo_filt=echo_filt, near_filt=near_filt,
        noise_est=noise_est, noise_est_too_low=too_low,
        noise_est_too_high=too_high, noise_est_ctr=noise_ctr, seed=seed,
    ), out
