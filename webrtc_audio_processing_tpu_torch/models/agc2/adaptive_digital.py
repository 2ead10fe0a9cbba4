"""AGC2 adaptive digital gain chain.

Port of ``webrtc_audio_processing_tpu/models/agc2/adaptive_digital.py``
(reference: agc2/noise_level_estimator.cc, agc2/speech_level_estimator_impl.cc,
agc2/saturation_protector.cc with its 4-slot peak ring, and
agc2/adaptive_digital_gain_controller.cc). Every component is a per-frame
step over per-stream scalars, (B,) tensors; the reference's branches become
``torch.where`` selects.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from webrtc_audio_processing_tpu_torch.config import AdaptiveDigital
from webrtc_audio_processing_tpu_torch.ops.audio_util import (
    MIN_DBFS,
    db_to_ratio,
    float_s16_to_dbfs,
)
from webrtc_audio_processing_tpu_torch.ops.gain_ramp import (
    ramped_gains_applier,
)

MIN_LEVEL_DBFS = -90.31  # agc2_common.h:21
VAD_CONFIDENCE_THRESHOLD = 0.95  # agc2_common.h:37
ADJACENT_SPEECH_FRAMES_THRESHOLD = 12  # agc2_common.h:41
LEVEL_ESTIMATOR_TIME_TO_CONFIDENCE_MS = 400  # agc2_common.h:45
LEVEL_ESTIMATOR_LEAK_FACTOR = 1.0 - 1.0 / LEVEL_ESTIMATOR_TIME_TO_CONFIDENCE_MS
SATURATION_PROTECTOR_INITIAL_HEADROOM_DB = 20.0  # agc2_common.h:50
SATURATION_BUFFER_SIZE = 4  # agc2_common.h:51
LIMITER_THRESHOLD_FOR_AGC_GAIN_DBFS = -1.0  # agc2_common.h:31
FRAME_DURATION_MS = 10
UPDATE_PERIOD_FRAMES = 500  # noise_level_estimator.cc:72


def _select(pred: torch.Tensor, a, b):
    """Leafwise torch.where over two states of one dataclass type."""
    out = {}
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(x):
            out[f.name] = _select(pred, x, y)
        else:
            p = pred.reshape(pred.shape + (1,) * (x.dim() - pred.dim()))
            out[f.name] = torch.where(p, x, y)
    return type(a)(**out)


def _scalar(batch, value, dtype, device):
    return torch.full((batch,), value, dtype=dtype, device=device)


def energy_to_dbfs(energy, num_samples: int):
    """EnergyToDbfs (noise_level_estimator.cc:40-48)."""
    rms_square = energy / num_samples
    return torch.where(
        rms_square <= 1.0,
        MIN_DBFS,
        10.0 * torch.log10(torch.clamp(rms_square, min=1.0)) + MIN_DBFS,
    )


def compute_audio_levels(x):
    """ComputeAudioLevels (gain_controller2.cc:79-94): first channel only.

    x: (B, N, C) floatS16. Returns (peak_dbfs, rms_dbfs), each (B,).
    """
    ch0 = x[:, :, 0]
    peak = torch.amax(torch.abs(ch0), dim=1)
    rms = torch.sqrt(torch.sum(ch0 * ch0, dim=1) / x.shape[1])
    return float_s16_to_dbfs(peak), float_s16_to_dbfs(rms)


# ---------------------------------------------------------------- noise floor


@dataclass
class NoiseFloorState:
    first_period: torch.Tensor  # (B,) bool
    preliminary_set: torch.Tensor  # (B,) bool
    preliminary_energy: torch.Tensor  # (B,)
    noise_energy: torch.Tensor  # (B,)
    counter: torch.Tensor  # (B,) int32


def _min_noise_energy(sample_rate_hz: int) -> float:
    # -84 dBFS floor (noise_level_estimator.cc:150).
    return sample_rate_hz * 2.0 * 2.0 / 100


def init_noise_floor(sample_rate_hz: int, batch: int,
                     device) -> NoiseFloorState:
    e = _min_noise_energy(sample_rate_hz)
    return NoiseFloorState(
        first_period=_scalar(batch, True, torch.bool, device),
        preliminary_set=_scalar(batch, False, torch.bool, device),
        preliminary_energy=_scalar(batch, e, torch.float32, device),
        noise_energy=_scalar(batch, e, torch.float32, device),
        counter=_scalar(batch, UPDATE_PERIOD_FRAMES, torch.int32, device),
    )


def noise_floor_analyze(state: NoiseFloorState, x, sample_rate_hz: int):
    """NoiseFloorEstimator::Analyze (noise_level_estimator.cc:85-140).

    x: (B, N, C) floatS16. Returns (state, noise_rms_dbfs (B,)).
    """
    n = x.shape[1]
    frame_energy = torch.amax(torch.sum(x * x, dim=1), dim=1)  # max channel
    low = frame_energy <= _min_noise_energy(sample_rate_hz)

    prelim = torch.where(
        state.preliminary_set,
        torch.minimum(state.preliminary_energy, frame_energy),
        frame_energy,
    )
    full_period = state.counter == 0
    # SmoothNoiseFloorEstimate (:56-64): slow attack, instant decay.
    smoothed = torch.where(
        state.noise_energy < prelim,
        0.5 * prelim + 0.5 * state.noise_energy,
        prelim,
    )
    noise_energy = torch.where(
        full_period,
        smoothed,
        torch.where(state.first_period, prelim,
                    torch.minimum(state.noise_energy, prelim)),
    )
    new_state = NoiseFloorState(
        first_period=state.first_period & ~full_period,
        preliminary_set=~full_period,
        preliminary_energy=prelim,
        noise_energy=noise_energy,
        counter=torch.where(full_period, UPDATE_PERIOD_FRAMES,
                            state.counter - 1).to(torch.int32),
    )
    # Low-energy frames leave the state untouched and report the floor.
    merged = _select(low, state, new_state)
    dbfs = energy_to_dbfs(torch.where(low, state.noise_energy, noise_energy), n)
    return merged, dbfs


# ------------------------------------------------------------ speech level


@dataclass
class SpeechLevelState:
    prelim_time_to_confidence: torch.Tensor
    prelim_num: torch.Tensor
    prelim_den: torch.Tensor
    reliable_time_to_confidence: torch.Tensor
    reliable_num: torch.Tensor
    reliable_den: torch.Tensor
    level_dbfs: torch.Tensor
    num_adjacent_speech_frames: torch.Tensor  # int32
    is_confident: torch.Tensor  # bool


def initial_speech_level_dbfs(config: AdaptiveDigital) -> float:
    """GetInitialSpeechLevelEstimateDbfs (speech_level_estimator_impl.cc:27-32)."""
    v = (
        -SATURATION_PROTECTOR_INITIAL_HEADROOM_DB
        - config.initial_gain_db
        - config.headroom_db
    )
    return float(min(max(v, -90.0), 30.0))


def init_speech_level(config: AdaptiveDigital, batch: int,
                      device) -> SpeechLevelState:
    lvl = initial_speech_level_dbfs(config)
    t = float(LEVEL_ESTIMATOR_TIME_TO_CONFIDENCE_MS)
    f = torch.float32
    return SpeechLevelState(
        prelim_time_to_confidence=_scalar(batch, t, f, device),
        prelim_num=_scalar(batch, lvl, f, device),
        prelim_den=_scalar(batch, 1.0, f, device),
        reliable_time_to_confidence=_scalar(batch, t, f, device),
        reliable_num=_scalar(batch, lvl, f, device),
        reliable_den=_scalar(batch, 1.0, f, device),
        level_dbfs=_scalar(batch, lvl, f, device),
        num_adjacent_speech_frames=_scalar(batch, 0, torch.int32, device),
        is_confident=_scalar(batch, False, torch.bool, device),
    )


def speech_level_update(state: SpeechLevelState, rms_dbfs, speech_probability):
    """SpeechLevelEstimatorImpl::Update (speech_level_estimator_impl.cc:57-107)."""
    is_speech = speech_probability >= VAD_CONFIDENCE_THRESHOLD
    thr = ADJACENT_SPEECH_FRAMES_THRESHOLD
    long_seq = state.num_adjacent_speech_frames >= thr
    short_seq = (state.num_adjacent_speech_frames > 0) & ~long_seq

    # Non-speech branch: confirm or roll back the preliminary state.
    confirm = ~is_speech & long_seq
    rollback = ~is_speech & short_seq
    rel_t = torch.where(confirm, state.prelim_time_to_confidence,
                        state.reliable_time_to_confidence)
    rel_num = torch.where(confirm, state.prelim_num, state.reliable_num)
    rel_den = torch.where(confirm, state.prelim_den, state.reliable_den)
    pre_t = torch.where(rollback, state.reliable_time_to_confidence,
                        state.prelim_time_to_confidence)
    pre_num = torch.where(rollback, state.reliable_num, state.prelim_num)
    pre_den = torch.where(rollback, state.reliable_den, state.prelim_den)

    # Speech branch: weighted-average update of the preliminary state.
    buffer_full = pre_t == 0.0
    pre_t_s = torch.where(buffer_full, pre_t, pre_t - FRAME_DURATION_MS)
    leak = torch.where(buffer_full, LEVEL_ESTIMATOR_LEAK_FACTOR, 1.0)
    pre_num_s = pre_num * leak + rms_dbfs * speech_probability
    pre_den_s = pre_den * leak + speech_probability

    n_adj = torch.where(is_speech, state.num_adjacent_speech_frames + 1, 0)
    pre_t = torch.where(is_speech, pre_t_s, pre_t)
    pre_num = torch.where(is_speech, pre_num_s, pre_num)
    pre_den = torch.where(is_speech, pre_den_s, pre_den)

    level = torch.where(
        is_speech & (n_adj >= thr),
        torch.clamp(pre_num / pre_den, -90.0, 30.0),
        state.level_dbfs,
    )
    is_confident = (rel_t == 0.0) | ((n_adj >= thr) & (pre_t == 0.0))
    return SpeechLevelState(
        prelim_time_to_confidence=pre_t,
        prelim_num=pre_num,
        prelim_den=pre_den,
        reliable_time_to_confidence=rel_t,
        reliable_num=rel_num,
        reliable_den=rel_den,
        level_dbfs=level,
        num_adjacent_speech_frames=n_adj.to(torch.int32),
        is_confident=is_confident,
    )


# --------------------------------------------------------- saturation protector


@dataclass
class SatProtectorRing:
    """SaturationProtectorBuffer (saturation_protector_buffer.{h,cc})."""

    buffer: torch.Tensor  # (B, 4)
    next: torch.Tensor  # (B,) int32
    size: torch.Tensor  # (B,) int32


@dataclass
class SatProtectorSubState:
    headroom_db: torch.Tensor
    ring: SatProtectorRing
    max_peaks_dbfs: torch.Tensor
    time_since_push_ms: torch.Tensor  # int32


@dataclass
class SaturationProtectorState:
    num_adjacent_speech_frames: torch.Tensor  # int32
    headroom_db: torch.Tensor
    preliminary: SatProtectorSubState
    reliable: SatProtectorSubState


def _init_sub(headroom_db, batch, device) -> SatProtectorSubState:
    return SatProtectorSubState(
        headroom_db=_scalar(batch, headroom_db, torch.float32, device),
        ring=SatProtectorRing(
            buffer=torch.zeros((batch, SATURATION_BUFFER_SIZE),
                               dtype=torch.float32, device=device),
            next=_scalar(batch, 0, torch.int32, device),
            size=_scalar(batch, 0, torch.int32, device),
        ),
        max_peaks_dbfs=_scalar(batch, MIN_LEVEL_DBFS, torch.float32, device),
        time_since_push_ms=_scalar(batch, 0, torch.int32, device),
    )


def init_saturation_protector(batch: int,
                              device) -> SaturationProtectorState:
    h = SATURATION_PROTECTOR_INITIAL_HEADROOM_DB
    return SaturationProtectorState(
        num_adjacent_speech_frames=_scalar(batch, 0, torch.int32, device),
        headroom_db=_scalar(batch, h, torch.float32, device),
        preliminary=_init_sub(h, batch, device),
        reliable=_init_sub(h, batch, device),
    )


def _sub_update(sub: SatProtectorSubState, peak_dbfs, speech_level_dbfs):
    """UpdateSaturationProtectorState (saturation_protector.cc:64-100)."""
    k_attack = 0.9988493699365052
    k_decay = 0.9997697679981565
    k_super_frame_ms = 400

    max_peaks = torch.maximum(sub.max_peaks_dbfs, peak_dbfs)
    t = sub.time_since_push_ms + FRAME_DURATION_MS
    push = t > k_super_frame_ms

    ring = sub.ring
    slots = torch.arange(SATURATION_BUFFER_SIZE, device=ring.buffer.device)
    new_buffer = torch.where(slots == ring.next[:, None], max_peaks[:, None],
                             ring.buffer)
    new_ring = SatProtectorRing(
        buffer=torch.where(push[:, None], new_buffer, ring.buffer),
        next=torch.where(push, (ring.next + 1) % SATURATION_BUFFER_SIZE,
                         ring.next).to(torch.int32),
        size=torch.where(
            push, torch.clamp(ring.size + 1, max=SATURATION_BUFFER_SIZE),
            ring.size,
        ).to(torch.int32),
    )
    max_peaks = torch.where(push, MIN_LEVEL_DBFS, max_peaks)
    t = torch.where(push, 0, t).to(torch.int32)

    # Front(): oldest element, or current max_peaks when empty
    # (saturation_protector_buffer.cc Front/FrontIndex).
    front_idx = torch.where(new_ring.size == SATURATION_BUFFER_SIZE,
                            new_ring.next, 0)
    front = torch.gather(new_ring.buffer, 1,
                         front_idx.to(torch.int64)[:, None])[:, 0]
    delayed_peak = torch.where(new_ring.size == 0, max_peaks, front)
    diff = delayed_peak - speech_level_dbfs
    headroom = torch.where(
        diff > sub.headroom_db,
        sub.headroom_db * k_attack + diff * (1.0 - k_attack),
        sub.headroom_db * k_decay + diff * (1.0 - k_decay),
    )
    headroom = torch.clamp(headroom, 12.0, 25.0)
    return SatProtectorSubState(
        headroom_db=headroom, ring=new_ring, max_peaks_dbfs=max_peaks,
        time_since_push_ms=t,
    )


def saturation_protector_analyze(
    state: SaturationProtectorState, speech_probability, peak_dbfs,
    speech_level_dbfs,
):
    """SaturationProtectorImpl::Analyze (saturation_protector.cc:117-148)."""
    thr = ADJACENT_SPEECH_FRAMES_THRESHOLD
    is_speech = speech_probability >= VAD_CONFIDENCE_THRESHOLD
    long_seq = state.num_adjacent_speech_frames >= thr
    short_seq = (state.num_adjacent_speech_frames > 0) & ~long_seq

    # Non-speech: confirm (reliable <- preliminary) or roll back.
    reliable = _select(~is_speech & long_seq, state.preliminary, state.reliable)
    preliminary = _select(~is_speech & short_seq, state.reliable,
                          state.preliminary)

    # Speech: update the preliminary state.
    updated = _sub_update(preliminary, peak_dbfs, speech_level_dbfs)
    preliminary = _select(is_speech, updated, preliminary)

    n_adj = torch.where(is_speech, state.num_adjacent_speech_frames + 1, 0)
    headroom = torch.where(is_speech & (n_adj >= thr),
                           preliminary.headroom_db, state.headroom_db)
    return SaturationProtectorState(
        num_adjacent_speech_frames=n_adj.to(torch.int32),
        headroom_db=headroom,
        preliminary=preliminary,
        reliable=reliable,
    )


# -------------------------------------------------- adaptive digital controller


@dataclass
class AdaptiveDigitalState:
    last_gain_db: torch.Tensor
    last_gain_factor: torch.Tensor  # GainApplier ramp memory
    frames_to_gain_increase_allowed: torch.Tensor  # int32


def init_adaptive_digital(config: AdaptiveDigital, batch: int,
                          device) -> AdaptiveDigitalState:
    return AdaptiveDigitalState(
        last_gain_db=_scalar(batch, config.initial_gain_db, torch.float32,
                             device),
        last_gain_factor=_scalar(batch, 10.0 ** (config.initial_gain_db / 20.0),
                                 torch.float32, device),
        frames_to_gain_increase_allowed=_scalar(
            batch, ADJACENT_SPEECH_FRAMES_THRESHOLD, torch.int32, device),
    )


def adaptive_digital_process(
    config: AdaptiveDigital,
    state: AdaptiveDigitalState,
    x,
    speech_probability,
    speech_level_dbfs,
    speech_level_reliable,
    noise_rms_dbfs,
    headroom_db,
    limiter_envelope_dbfs,
):
    """AdaptiveDigitalGainController::Process
    (adaptive_digital_gain_controller.cc:133-229). x: (B, N, C) floatS16."""
    max_change_per_10ms = config.max_gain_change_db_per_second * 0.01

    # ComputeGainDb (:40-54).
    input_level = speech_level_dbfs + headroom_db
    gain_db = torch.where(
        input_level < -(config.headroom_db + config.max_gain_db),
        config.max_gain_db,
        torch.where(input_level < -config.headroom_db,
                    -config.headroom_db - input_level, 0.0),
    )
    # LimitGainByNoise (:60-70).
    max_by_noise = config.max_output_noise_level_dbfs - noise_rms_dbfs
    gain_db = torch.minimum(gain_db, torch.clamp(max_by_noise, min=0.0))
    # LimitGainByLowConfidence (:72-88).
    low_conf = (~speech_level_reliable) & (
        limiter_envelope_dbfs > LIMITER_THRESHOLD_FOR_AGC_GAIN_DBFS
    )
    level_before = limiter_envelope_dbfs - state.last_gain_db
    new_target = torch.clamp(
        LIMITER_THRESHOLD_FOR_AGC_GAIN_DBFS - level_before, min=0.0)
    target_gain_db = torch.where(low_conf, torch.minimum(new_target, gain_db),
                                 gain_db)

    # Adjacent speech-frame gating (:152-176).
    is_speech = speech_probability >= VAD_CONFIDENCE_THRESHOLD
    frames = torch.where(
        ~is_speech,
        ADJACENT_SPEECH_FRAMES_THRESHOLD,
        torch.clamp(state.frames_to_gain_increase_allowed - 1, min=0),
    )
    first_confident = is_speech & (frames == 0) & (
        state.frames_to_gain_increase_allowed > 0
    )
    gain_increase_allowed = frames == 0
    max_increase = torch.where(
        first_confident,
        max_change_per_10ms * ADJACENT_SPEECH_FRAMES_THRESHOLD,
        max_change_per_10ms,
    )

    # ComputeGainChangeThisFrameDb (:92-105).
    diff = target_gain_db - state.last_gain_db
    diff = torch.where(gain_increase_allowed, diff,
                       torch.clamp(diff, max=0.0))
    change = torch.minimum(torch.maximum(diff, torch.full_like(
        diff, -max_change_per_10ms)), max_increase)

    new_gain_db = state.last_gain_db + change
    current_factor = torch.where(change != 0.0, db_to_ratio(new_gain_db),
                                 state.last_gain_factor)
    g = ramped_gains_applier(state.last_gain_factor, current_factor,
                             x.shape[1])
    y = x * g[:, :, None]
    return (
        AdaptiveDigitalState(
            last_gain_db=new_gain_db,
            last_gain_factor=current_factor,
            frames_to_gain_increase_allowed=frames.to(torch.int32),
        ),
        y,
    )
