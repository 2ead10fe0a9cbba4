"""RNN-VAD pitch estimation on the LP residual.

Port of ``webrtc_audio_processing_tpu/models/agc2/rnn_vad/pitch.py``
(reference: agc2/rnn_vad/pitch_search.cc, pitch_search_internal.cc). Two
stages: a coarse search at 12 kHz over 147 lags, refinement at 24 kHz
around the two best candidates, then the sub-harmonic extension with pitch
tracking. All inputs are batched (B, ...).

Auto-correlations are valid-mode correlations of the pitch buffer against
the reference frame, one grouped ``conv1d`` per rate. The sliding-window
energies with per-step floor clamping use the closed form
y[n] = max(S[n], floor + S[n] - min_{k<=n} S[k]) over prefix sums. The
data-dependent lag reads, one-hot contractions in the JAX package, are
plain gathers here: both read the same single element.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

SAMPLE_RATE_24K = 24000
FRAME_10MS_24K = 240
FRAME_20MS_24K = 480
MIN_PITCH_24K = 30
MAX_PITCH_24K = 384
BUF_SIZE_24K = MAX_PITCH_24K + FRAME_20MS_24K  # 864
INITIAL_MIN_PITCH_24K = 3 * MIN_PITCH_24K  # 90
INITIAL_NUM_LAGS_24K = MAX_PITCH_24K - INITIAL_MIN_PITCH_24K  # 294
REFINE_NUM_LAGS_24K = MAX_PITCH_24K + 1  # 385

FRAME_20MS_12K = 240
BUF_SIZE_12K = BUF_SIZE_24K // 2  # 432
MAX_PITCH_12K = MAX_PITCH_24K // 2  # 192
NUM_LAGS_12K = MAX_PITCH_12K - INITIAL_MIN_PITCH_24K // 2  # 147

MIN_PITCH_48K = 2 * MIN_PITCH_24K  # 60
MAX_PITCH_48K = 2 * MAX_PITCH_24K  # 768

# kSubHarmonicMultipliers (pitch_search_internal.cc:106) and
# kInitialPitchPeriodThresholds (:241).
SUB_HARMONIC_MULTIPLIERS = (3, 2, 3, 2, 5, 2, 3, 2, 3, 2, 5, 2, 3, 2)
INITIAL_PERIOD_THRESHOLDS = (
    20, 45, 80, 125, 180, 245, 320, 405, 500, 605, 720, 845, 980, 1125
)


def _clamped_sliding_energy(first_energy, old_sq, new_sq, floor: float):
    """y[0] = first_energy; y[i+1] = max(floor, y[i] - old_sq[i] + new_sq[i]).

    first_energy (B,), old_sq/new_sq (B, n) -> (B, n + 1).
    """
    d = new_sq - old_sq
    s = first_energy[:, None] + torch.cat(
        [torch.zeros_like(d[:, :1]), torch.cumsum(d, dim=1)], dim=1
    )
    run_min = torch.cummin(s[:, 1:], dim=1).values
    clamped = torch.maximum(s[:, 1:], floor + s[:, 1:] - run_min)
    return torch.cat([s[:, :1], clamped], dim=1)


def _correlate_lags(pitch_buffer, x_ref, num_lags: int):
    """ac[b, l] = dot(pitch_buffer[b, l : l + W], x_ref[b]) for l < num_lags
    (ComputeAutoCorrelation, pitch_search_internal.cc:29-38)."""
    B = pitch_buffer.shape[0]
    out = F.conv1d(pitch_buffer[None], x_ref[:, None, :], groups=B)[0]
    return out[:, :num_lags]


def _at(vec, idx):
    """vec[b, idx[b]] for (B, n) vec and (B,) idx."""
    return torch.gather(vec, 1, idx.to(torch.int64)[:, None])[:, 0]


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _pseudo_interp_offset(prev, curr, nxt):
    """GetPitchPseudoInterpolationOffset (pitch_search_internal.cc:49-62)."""
    plus = (nxt - prev) > 0.7 * (curr - prev)
    minus = (prev - nxt) > 0.7 * (curr - nxt)
    zero = torch.zeros_like(prev, dtype=torch.int64)
    return torch.where(plus, zero + 1, torch.where(minus, zero - 1, zero))


def compute_sliding_frame_energies_24k(pitch_buffer):
    """ComputeSlidingFrameSquareEnergies24kHz
    (pitch_search_internal.cc:292-310). Returns (B, 385) energies."""
    head = pitch_buffer[:, :FRAME_20MS_24K]
    first = _dot(head, head)
    old_sq = pitch_buffer[:, :MAX_PITCH_24K] ** 2
    new_sq = pitch_buffer[:, FRAME_20MS_24K: FRAME_20MS_24K + MAX_PITCH_24K] ** 2
    return _clamped_sliding_energy(first, old_sq, new_sq, 1.0)


def compute_pitch_period_12k(pitch_buffer_12k, auto_correlation):
    """ComputePitchPeriod12kHz (pitch_search_internal.cc:312-369).

    Returns (best, second_best) inverted lags, each (B,) int64.
    """
    frame = pitch_buffer_12k[:, : FRAME_20MS_12K + 1]
    first = 1.0 + _dot(frame, frame)
    old_sq = pitch_buffer_12k[:, :NUM_LAGS_12K] ** 2
    new_sq = pitch_buffer_12k[
        :, FRAME_20MS_12K: FRAME_20MS_12K + NUM_LAGS_12K] ** 2
    # Denominator before the lag's own update: y[l] for l in [0, 147).
    den = _clamped_sliding_energy(first, old_sq, new_sq, 0.0)[:, :NUM_LAGS_12K]

    valid = (auto_correlation > 0.0) & (den > 0.0)
    key = torch.where(
        valid, auto_correlation ** 2 / torch.clamp(den, min=1e-30),
        -float("inf"),
    )
    best = torch.argmax(key, dim=1)
    any_valid = torch.any(valid, dim=1)
    lags = torch.arange(NUM_LAGS_12K, device=key.device)
    not_best = lags != best[:, None]
    key2 = torch.where(not_best, key, -float("inf"))
    second = torch.argmax(key2, dim=1)
    has_second = torch.any(valid & not_best, dim=1)
    best = torch.where(any_valid, best, 0)
    second = torch.where(has_second, second, 1)
    return best, second


def compute_pitch_period_48k(pitch_buffer, y_energy, best, second_best):
    """ComputePitchPeriod48kHz (pitch_search_internal.cc:371-407 + 181-220).

    best/second_best: candidate inverted lags at 24 kHz (already doubled).
    Returns the refined pitch inverted lag at 48 kHz scale, (B,) int64.
    """
    radius = 2
    top = INITIAL_NUM_LAGS_24K - 1
    x_ref = pitch_buffer[:, MAX_PITCH_24K:]
    ac = _correlate_lags(pitch_buffer, x_ref, INITIAL_NUM_LAGS_24K)
    lo_c = torch.minimum(best, second_best)
    hi_c = torch.maximum(best, second_best)
    lo1 = torch.clamp(lo_c - radius, 0, top)[:, None]
    hi1 = torch.clamp(lo_c + radius, 0, top)[:, None]
    lo2 = torch.clamp(hi_c - radius, 0, top)[:, None]
    hi2 = torch.clamp(hi_c + radius, 0, top)[:, None]

    # Dense correlation over all initial lags, masked to the lags the
    # reference actually computes.
    lags = torch.arange(INITIAL_NUM_LAGS_24K, device=ac.device)
    in_ranges = ((lags >= lo1) & (lags <= hi1)) | ((lags >= lo2) & (lags <= hi2))

    den = y_energy[:, :INITIAL_NUM_LAGS_24K]
    valid = in_ranges & (ac > 0.0) & (den > 0.0)
    key = torch.where(valid, ac ** 2 / torch.clamp(den, min=1e-30),
                      -float("inf"))
    best_il = torch.where(torch.any(valid, dim=1), torch.argmax(key, dim=1), 0)

    # Pseudo-interpolation; uncomputed neighbour lags read as 0 (the
    # reference zeroes the range boundaries, :160-167).
    ip = torch.clamp(best_il + 1, 0, top)
    im = torch.clamp(best_il - 1, 0, top)
    nb_prev = torch.where(_at(in_ranges, ip), _at(ac, ip), 0.0)
    nb_next = torch.where(_at(in_ranges, im), _at(ac, im), 0.0)
    offset = _pseudo_interp_offset(nb_prev, _at(ac, best_il), nb_next)
    at_boundary = (best_il == 0) | (best_il >= top)
    return torch.where(at_boundary, 2 * best_il, 2 * best_il + offset)


def _alternative_period(period, multiplier: int, divisor: int):
    """GetAlternativePitchPeriod (pitch_search_internal.cc:224-230)."""
    return torch.div(2 * multiplier * period + divisor, 2 * divisor,
                     rounding_mode="floor")


def compute_extended_pitch_period_48k(
    pitch_buffer, y_energy, initial_pitch_period_48k, last_period_48k,
    last_strength,
):
    """ComputeExtendedPitchPeriod48kHz (pitch_search_internal.cc:409-512).

    Returns (period_48k (B,) int64, strength (B,)).
    """
    x_ref = pitch_buffer[:, MAX_PITCH_24K:]
    x_energy = y_energy[:, MAX_PITCH_24K]
    ac_full = _correlate_lags(pitch_buffer, x_ref, REFINE_NUM_LAGS_24K)

    def strength_of(xy, yy):
        return xy / torch.sqrt(1.0 + x_energy * yy)

    init_period = torch.clamp(
        torch.div(initial_pitch_period_48k, 2, rounding_mode="floor"),
        max=MAX_PITCH_24K - 1,
    )
    init_xy = _at(ac_full, MAX_PITCH_24K - init_period)
    init_yy = _at(y_energy, MAX_PITCH_24K - init_period)
    init_strength = strength_of(init_xy, init_yy)

    last_period = torch.div(last_period_48k.to(torch.int64), 2,
                            rounding_mode="floor")
    max_divisor = torch.div(2 * init_period, 2 * MIN_PITCH_24K - 1,
                            rounding_mode="floor")

    best_period = init_period
    best_strength = init_strength
    best_xy = init_xy
    best_yy = init_yy

    for divisor in range(2, 16):
        active = divisor <= max_divisor
        alt_period = _alternative_period(init_period, 1, divisor)
        dual = _alternative_period(
            init_period, SUB_HARMONIC_MULTIPLIERS[divisor - 2], divisor
        )
        if divisor == 2:
            dual = torch.where(dual > MAX_PITCH_24K, init_period, dual)
        alt_period_c = torch.clamp(alt_period, 0, MAX_PITCH_24K)
        dual_c = torch.clamp(dual, 0, MAX_PITCH_24K)
        xy1 = _at(ac_full, MAX_PITCH_24K - alt_period_c)
        xy2 = _at(ac_full, MAX_PITCH_24K - dual_c)
        xy = 0.5 * (xy1 + xy2)
        yy = 0.5 * (
            _at(y_energy, MAX_PITCH_24K - alt_period_c)
            + _at(y_energy, MAX_PITCH_24K - dual_c)
        )
        alt_strength = strength_of(xy, yy)

        # IsAlternativePitchStrongerThanInitial (:235-279).
        close1 = torch.abs(alt_period - last_period) <= 1
        close2 = (torch.abs(alt_period - last_period) == 2) & (
            init_period > INITIAL_PERIOD_THRESHOLDS[divisor - 2]
        )
        lower_term = torch.where(
            close1, last_strength,
            torch.where(close2, 0.5 * last_strength, 0.0),
        )
        threshold = torch.clamp(0.7 * init_strength - lower_term, min=0.3)
        threshold = torch.where(
            alt_period < 3 * MIN_PITCH_24K,
            torch.clamp(0.85 * init_strength - lower_term, min=0.4),
            threshold,
        )
        threshold = torch.where(
            alt_period < 2 * MIN_PITCH_24K,
            torch.clamp(0.9 * init_strength - lower_term, min=0.5),
            threshold,
        )
        take = active & (alt_strength > threshold)
        best_period = torch.where(take, alt_period, best_period)
        best_strength = torch.where(take, alt_strength, best_strength)
        best_xy = torch.where(take, xy, best_xy)
        best_yy = torch.where(take, yy, best_yy)

    best_xy = torch.clamp(best_xy, min=0.0)
    final_strength = torch.where(best_yy <= best_xy, 1.0,
                                 best_xy / (best_yy + 1.0))
    final_strength = torch.minimum(best_strength, final_strength)

    # PitchPseudoInterpolationLagPitchBuf (:66-80).
    il = MAX_PITCH_24K - best_period
    can_interp = (best_period > 0) & (best_period < MAX_PITCH_24K)
    ilc = torch.clamp(il, 1, MAX_PITCH_24K - 1)
    prev = _at(ac_full, ilc + 1)
    curr = _at(ac_full, ilc)
    nxt = _at(ac_full, ilc - 1)
    offset = torch.where(can_interp, _pseudo_interp_offset(prev, curr, nxt),
                         0)
    final_period = torch.clamp(2 * best_period + offset, min=MIN_PITCH_48K)
    return final_period, final_strength


def estimate_pitch(pitch_buffer, last_period_48k, last_strength):
    """PitchEstimator::Estimate (pitch_search.cc:33-71).

    pitch_buffer: (B, 864) LP residual. Returns (period_48k (B,) int64,
    strength (B,)).
    """
    pitch12 = pitch_buffer[:, ::2].contiguous()  # Decimate2x, no filter
    auto_corr12 = _correlate_lags(
        pitch12, pitch12[:, BUF_SIZE_12K - FRAME_20MS_12K:], NUM_LAGS_12K
    )
    best12, second12 = compute_pitch_period_12k(pitch12, auto_corr12)

    y_energy = compute_sliding_frame_energies_24k(pitch_buffer)
    lag48 = compute_pitch_period_48k(pitch_buffer, y_energy, 2 * best12,
                                     2 * second12)
    return compute_extended_pitch_period_48k(
        pitch_buffer, y_energy, MAX_PITCH_48K - lag48, last_period_48k,
        last_strength,
    )
