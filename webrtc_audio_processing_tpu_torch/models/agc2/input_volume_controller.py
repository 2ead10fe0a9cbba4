"""InputVolumeController: AGC2's microphone input-volume recommendation.

Port of ``webrtc_audio_processing_tpu/models/agc2/input_volume_controller.py``
(reference: agc2/input_volume_controller.cc, agc2/gain_map_internal.h,
agc2/clipping_predictor.cc, agc2/clipping_predictor_level_buffer.cc). The
reference's per-channel control flow is a lattice of ``torch.where``
selects over the mono controllers' state, (B, C) leaves; the gain-map
walks are first-index searches over the 256-entry map. Volumes are int32.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from webrtc_audio_processing_tpu_torch.ops.batch import const, tree_where

MAX_INPUT_VOLUME = 255
VOLUME_QUANTIZATION_SLACK = 25
MAX_ABS_RMS_ERROR_DBFS = 15
CLIPPING_PREDICTOR_MAX_GAIN_CHANGE = 15

# kGainMap (gain_map_internal.h:17-44), from its documented generator
# formula: round(SF*x + (SI-SF)*(1-exp(-D*x))/D - 56).
_SI, _SF, _D = 2.0, 0.25, 8.0 / 256.0
_x = np.linspace(0, 255, 256)
GAIN_MAP = np.round(
    _SF * _x + (_SI - _SF) * (1.0 - np.exp(-_D * _x)) / _D - 56.0
).astype(np.int32)
assert GAIN_MAP[0] == -56 and GAIN_MAP[-1] == 64 and GAIN_MAP[48] == 0

_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class ClippingPredictorConfig:
    """GainController1::AnalogGainController::ClippingPredictor
    (audio_processing.h:294-319)."""

    enabled: bool = False
    mode: int = 0  # 0: event, 1: adaptive-step peak, 2: fixed-step peak
    window_length: int = 5
    reference_window_length: int = 5
    reference_window_delay: int = 5
    clipping_threshold: float = -1.0
    crest_factor_margin: float = 3.0
    use_predicted_step: bool = True

    @property
    def buffer_length(self) -> int:
        return self.reference_window_delay + self.reference_window_length


@dataclasses.dataclass(frozen=True)
class InputVolumeControllerConfig:
    """InputVolumeController::Config (input_volume_controller.h:37-70)."""

    min_input_volume: int = 20
    clipped_level_min: int = 70
    clipped_level_step: int = 15
    clipped_ratio_threshold: float = 0.1
    clipped_wait_frames: int = 300
    enable_clipping_predictor: bool = True
    target_range_max_dbfs: int = -30
    target_range_min_dbfs: int = -50
    update_input_volume_wait_frames: int = 100
    speech_probability_threshold: float = 0.7
    speech_ratio_threshold: float = 0.6

    @property
    def clipping_predictor(self) -> ClippingPredictorConfig:
        return ClippingPredictorConfig(enabled=self.enable_clipping_predictor)


def _float_s16_to_dbfs(v):
    """FloatS16ToDbfs (common_audio/include/audio_util.h)."""
    return 20.0 * torch.log10(torch.clamp(v, min=1e-20) / 32768.0)


def compute_volume_update(gain_error_db, input_volume, min_input_volume,
                          max_input_volume=MAX_INPUT_VOLUME):
    """ComputeVolumeUpdate (input_volume_controller.cc:61-83): the walks
    over the gain map as first-index searches. ``gain_error_db`` and
    ``input_volume`` are int tensors of one shape; returns int32."""
    gm = const(tuple(GAIN_MAP.tolist()), _I32, input_volume.device)
    vols = torch.arange(256, dtype=_I32, device=input_volume.device)
    err = gain_error_db[..., None]
    vol = input_volume[..., None]
    base = gm[input_volume.long()][..., None]

    # Ascending walk: the first v >= input_volume with gm[v]-base >= err.
    up_ok = (gm - base >= err) & (vols >= vol)
    up = torch.where(up_ok.any(-1), torch.argmax(up_ok.to(_I32), -1),
                     max_input_volume)
    up = torch.clamp(up, max=max_input_volume)

    # Descending walk: the first v <= input_volume, downwards, with
    # gm[v]-base <= err, floored at min_input_volume.
    down_ok = (gm - base <= err) & (vols <= vol) & (vols >= min_input_volume)
    down = torch.where(down_ok.any(-1),
                       255 - torch.argmax(down_ok.flip(-1).to(_I32), -1),
                       min_input_volume)
    down = torch.clamp(down, min=min_input_volume)

    return torch.where(gain_error_db == 0, input_volume.long(),
                       torch.where(gain_error_db > 0, up, down)).to(_I32)


def get_speech_level_rms_error_db(speech_level_dbfs, range_min, range_max):
    """GetSpeechLevelRmsErrorDb (input_volume_controller.cc:117-135)."""
    lvl = torch.clamp(speech_level_dbfs, -90.0, 30.0)
    err = torch.where(
        lvl > range_max, torch.round(range_max - lvl),
        torch.where(lvl < range_min, torch.round(range_min - lvl),
                    torch.zeros_like(lvl)))
    return err.to(_I32)


# ------------------------------------------------------------------ mono


@dataclass
class MonoInputVolumeControllerState:
    """One controller per capture channel: every leaf (B, C)."""

    recommended_input_volume: torch.Tensor  # int32
    last_recommended_input_volume: torch.Tensor  # int32
    max_input_volume: torch.Tensor  # int32
    check_volume_on_next_process: torch.Tensor  # bool
    startup: torch.Tensor  # bool
    frames_since_update: torch.Tensor  # int32
    speech_frames_since_update: torch.Tensor  # int32
    is_first_frame: torch.Tensor  # bool

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def init_mono_state(batch: int, num_channels: int,
                    device) -> MonoInputVolumeControllerState:
    shape = (batch, num_channels)

    def full(v, dtype):
        return torch.full(shape, v, dtype=dtype, device=device)

    return MonoInputVolumeControllerState(
        recommended_input_volume=full(0, _I32),
        last_recommended_input_volume=full(0, _I32),
        max_input_volume=full(MAX_INPUT_VOLUME, _I32),
        check_volume_on_next_process=full(True, torch.bool),
        startup=full(True, torch.bool),
        frames_since_update=full(0, _I32),
        speech_frames_since_update=full(0, _I32),
        is_first_frame=full(True, torch.bool),
    )


def _i32(x):
    return x.to(_I32)


def _check_volume_and_reset(cfg: InputVolumeControllerConfig, st):
    """CheckVolumeAndReset (input_volume_controller.cc:323-356)."""
    vol = st.recommended_input_volume
    skip = (vol == 0) & ~st.startup
    raised = torch.clamp(vol, min=cfg.min_input_volume)
    return st.replace(
        recommended_input_volume=_i32(torch.where(skip, vol, raised)),
        last_recommended_input_volume=_i32(torch.where(
            skip, st.last_recommended_input_volume, raised)),
        startup=torch.where(skip, st.startup, False),
        frames_since_update=_i32(torch.where(skip, st.frames_since_update,
                                             0)),
        speech_frames_since_update=_i32(torch.where(
            skip, st.speech_frames_since_update, 0)),
        is_first_frame=torch.where(skip, st.is_first_frame, True),
    )


def _set_input_volume(cfg: InputVolumeControllerConfig, st, new_volume):
    """SetInputVolume (input_volume_controller.cc:252-301)."""
    applied = st.recommended_input_volume
    invalid = applied == 0  # int32 volumes cannot leave [0, 255] otherwise
    last = st.last_recommended_input_volume
    manual = ((applied > last + VOLUME_QUANTIZATION_SLACK)
              | (applied < last - VOLUME_QUANTIZATION_SLACK))
    man_max = torch.maximum(st.max_input_volume, applied)
    clamped = torch.minimum(new_volume, st.max_input_volume)
    take = ~invalid & ~manual & (clamped != last)
    reset = ~invalid & manual
    return st.replace(
        recommended_input_volume=_i32(torch.where(take, clamped, applied)),
        last_recommended_input_volume=_i32(torch.where(
            invalid, last,
            torch.where(manual, applied, torch.where(take, clamped, last)))),
        max_input_volume=_i32(torch.where(reset, man_max,
                                          st.max_input_volume)),
        frames_since_update=_i32(torch.where(reset, 0,
                                             st.frames_since_update)),
        speech_frames_since_update=_i32(torch.where(
            reset, 0, st.speech_frames_since_update)),
        is_first_frame=torch.where(reset, False, st.is_first_frame),
    )


def mono_process(cfg: InputVolumeControllerConfig, st, rms_error_db,
                 has_rms_error, speech_probability):
    """MonoInputVolumeController::Process (input_volume_controller.cc:193);
    ``rms_error_db``, ``has_rms_error`` and ``speech_probability`` (B, 1)."""
    st = tree_where(st.check_volume_on_next_process,
                    _check_volume_and_reset(cfg, st), st)
    st = st.replace(check_volume_on_next_process=torch.zeros_like(
        st.check_volume_on_next_process))

    speech = speech_probability >= cfg.speech_probability_threshold
    speech_frames = _i32(st.speech_frames_since_update + speech.to(_I32))
    frames = _i32(st.frames_since_update + 1)

    wait = max(cfg.update_input_volume_wait_frames, 1)
    due = frames >= wait
    speech_ratio = speech_frames.to(torch.float32) / float(wait)
    update = (due & ~st.is_first_frame
              & (speech_ratio >= cfg.speech_ratio_threshold) & has_rms_error)

    # UpdateInputVolume (:358-369).
    err = torch.clamp(rms_error_db, -MAX_ABS_RMS_ERROR_DBFS,
                      MAX_ABS_RMS_ERROR_DBFS).expand_as(frames)
    new_vol = compute_volume_update(err, st.last_recommended_input_volume,
                                    cfg.min_input_volume)
    st = tree_where(update & (err != 0), _set_input_volume(cfg, st, new_vol),
                    st)
    return st.replace(
        frames_since_update=_i32(torch.where(due, 0, frames)),
        speech_frames_since_update=_i32(torch.where(due, 0, speech_frames)),
        is_first_frame=torch.zeros_like(st.is_first_frame),
    )


def mono_handle_clipping(cfg: InputVolumeControllerConfig, st,
                         clipped_level_step, do_it):
    """HandleClipping (input_volume_controller.cc:228-250);
    ``clipped_level_step`` and ``do_it`` (B, 1)."""
    new_max = _i32(torch.clamp(st.max_input_volume - clipped_level_step,
                               min=cfg.clipped_level_min))
    adjust = st.last_recommended_input_volume > cfg.clipped_level_min
    target = _i32(torch.clamp(
        st.last_recommended_input_volume - clipped_level_step,
        min=cfg.clipped_level_min))
    adjusted = _set_input_volume(cfg, st.replace(max_input_volume=new_max),
                                 target)
    adjusted = adjusted.replace(
        frames_since_update=torch.zeros_like(st.frames_since_update),
        speech_frames_since_update=torch.zeros_like(
            st.speech_frames_since_update),
        is_first_frame=torch.zeros_like(st.is_first_frame),
    )
    picked = tree_where(adjust, adjusted, st.replace(max_input_volume=new_max))
    return tree_where(do_it.expand_as(adjust), picked, st)


# ------------------------------------------------- clipping predictor


@dataclass
class ClippingPredictorState:
    """Per-channel level ring (clipping_predictor_level_buffer.cc)."""

    averages: torch.Tensor  # (B, C, L) frame mean squares
    maxima: torch.Tensor  # (B, C, L) frame peaks
    tail: torch.Tensor  # (B,) int32
    size: torch.Tensor  # (B,) int32

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def init_clipping_predictor(num_channels: int, cfg: ClippingPredictorConfig,
                            batch: int, device) -> ClippingPredictorState:
    L = cfg.buffer_length
    return ClippingPredictorState(
        averages=torch.zeros((batch, num_channels, L), dtype=torch.float32,
                             device=device),
        maxima=torch.zeros((batch, num_channels, L), dtype=torch.float32,
                           device=device),
        tail=torch.full((batch,), -1, dtype=_I32, device=device),
        size=torch.zeros((batch,), dtype=_I32, device=device),
    )


def clipping_predictor_analyze(cfg: ClippingPredictorConfig, st, audio):
    """Analyze (clipping_predictor.cc:115-133): push the frame's per-channel
    mean square and peak; ``audio`` (B, N, C)."""
    mean_sq = torch.mean(audio * audio, dim=1)  # (B, C)
    peak = torch.amax(torch.abs(audio), dim=1)
    L = cfg.buffer_length
    tail = _i32(torch.remainder(st.tail + 1, L))
    slot = (torch.arange(L, device=audio.device) == tail[:, None])[:, None]
    return st.replace(
        averages=torch.where(slot, mean_sq[..., None], st.averages),
        maxima=torch.where(slot, peak[..., None], st.maxima),
        tail=tail,
        size=_i32(torch.clamp(st.size + 1, max=L)),
    )


def _partial_metrics(cfg: ClippingPredictorConfig, st, delay, num_items):
    """ComputePartialMetrics (clipping_predictor_level_buffer.cc:39-62):
    (average (B, C), maximum (B, C), valid (B, 1))."""
    L = cfg.buffer_length
    steps = torch.arange(num_items, device=st.tail.device)
    idx = torch.remainder(st.tail[:, None] - delay - steps, L)  # (B, n)
    idx = idx[:, None, :].expand(-1, st.averages.shape[1], -1).long()
    avg = torch.mean(torch.gather(st.averages, 2, idx), dim=-1)
    mx = torch.amax(torch.gather(st.maxima, 2, idx), dim=-1)
    valid = ((delay + num_items) <= st.size)[:, None]
    return avg, mx, valid


def clipping_predictor_step(cfg: ClippingPredictorConfig, st, level,
                            default_step, min_level=70):
    """EstimateClippedLevelStep for every channel at once; ``level`` (B,).
    Returns (has_step (B, C), step (B, C) int32): the event mode
    (clipping_predictor.cc:140-196) and the peak modes (:277-322)."""
    a_w, m_w, ok_w = _partial_metrics(cfg, st, 0, cfg.window_length)
    a_r, m_r, ok_r = _partial_metrics(cfg, st, cfg.reference_window_delay,
                                      cfg.reference_window_length)
    crest = _float_s16_to_dbfs(m_w) - _float_s16_to_dbfs(torch.sqrt(a_w))
    crest_ref = _float_s16_to_dbfs(m_r) - _float_s16_to_dbfs(torch.sqrt(a_r))
    above = _float_s16_to_dbfs(m_w) > cfg.clipping_threshold
    level = level[:, None]

    if cfg.mode == 0:
        predicted = ok_w & ok_r & above & (
            crest < crest_ref - cfg.crest_factor_margin)
        new_level = torch.clamp(level - default_step, min_level,
                                MAX_INPUT_VOLUME)
        step = level - new_level
        has = predicted & (level > min_level) & (step > 0)
        return has, _i32(step.expand_as(has))
    projected_peak = crest_ref + _float_s16_to_dbfs(torch.sqrt(a_w))
    predicted = ok_w & ok_r & above & (projected_peak > cfg.clipping_threshold)
    if cfg.mode == 2:
        step = torch.full_like(level, default_step).expand_as(predicted)
    else:
        gain_change = torch.clamp(-_i32(torch.ceil(projected_peak)),
                                  -CLIPPING_PREDICTOR_MAX_GAIN_CHANGE, 0)
        vol = compute_volume_update(gain_change, level.expand_as(gain_change),
                                    min_level)
        step = torch.clamp(level - vol, min=default_step)
    new_level = torch.clamp(level - step, min_level, MAX_INPUT_VOLUME)
    has = predicted & (level > min_level) & (level > new_level)
    return has, _i32(level - new_level)


# ------------------------------------------------------------- top level


@dataclass
class InputVolumeControllerState:
    monos: MonoInputVolumeControllerState  # (B, C) leaves
    frames_since_clipped: torch.Tensor  # (B,) int32
    predictor: ClippingPredictorState | None
    applied_input_volume: torch.Tensor  # (B,) int32, -1 = unset
    recommended_input_volume: torch.Tensor  # (B,) int32

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def init_state(cfg: InputVolumeControllerConfig, num_channels: int,
               batch: int, device) -> InputVolumeControllerState:
    return InputVolumeControllerState(
        monos=init_mono_state(batch, num_channels, device),
        frames_since_clipped=torch.full((batch,), cfg.clipped_wait_frames,
                                        dtype=_I32, device=device),
        predictor=(init_clipping_predictor(num_channels,
                                           cfg.clipping_predictor, batch,
                                           device)
                   if cfg.enable_clipping_predictor else None),
        applied_input_volume=torch.full((batch,), -1, dtype=_I32,
                                        device=device),
        recommended_input_volume=torch.zeros((batch,), dtype=_I32,
                                             device=device),
    )


def _aggregate(cfg: InputVolumeControllerConfig, st):
    """AggregateChannelLevels (input_volume_controller.cc:578-597)."""
    rec = torch.amin(st.monos.recommended_input_volume, dim=-1)
    rec = torch.where(st.applied_input_volume > 0,
                      torch.clamp(rec, min=cfg.min_input_volume), rec)
    return st.replace(recommended_input_volume=_i32(rec))


def analyze_input_audio(cfg: InputVolumeControllerConfig, st,
                        applied_input_volume, audio):
    """AnalyzeInputAudio (input_volume_controller.cc:429-518).

    ``applied_input_volume`` an int or (B,) int tensor; ``audio`` (B, N, C)
    float_s16, the pre-processing capture frame."""
    applied = torch.as_tensor(applied_input_volume, dtype=_I32,
                              device=audio.device).expand_as(
                                  st.applied_input_volume)
    monos = st.monos
    st = st.replace(
        applied_input_volume=applied.clone(),
        monos=monos.replace(recommended_input_volume=applied[:, None]
                            .expand_as(monos.recommended_input_volume)
                            .clone()))
    st = _aggregate(cfg, st)

    pred = st.predictor
    if pred is not None:
        pred = clipping_predictor_analyze(cfg.clipping_predictor, pred, audio)

    # ComputeClippedRatio (:87-103): the largest per-channel share of
    # clipped samples.
    clipped = (audio >= 32767.0) | (audio <= -32768.0)
    ratio = torch.amax(torch.mean(clipped.to(torch.float32), dim=1), dim=-1)

    waiting = st.frames_since_clipped < cfg.clipped_wait_frames
    act = ~waiting & (ratio > cfg.clipped_ratio_threshold)
    step = torch.full_like(st.frames_since_clipped, cfg.clipped_level_step)
    if pred is not None:
        pcfg = cfg.clipping_predictor
        has, steps = clipping_predictor_step(
            pcfg, pred, st.recommended_input_volume, cfg.clipped_level_step,
            min_level=cfg.clipped_level_min)
        clipping_predicted = ~waiting & has.any(-1)
        predicted_step = torch.clamp(
            torch.amax(torch.where(has, steps, 0), dim=-1),
            min=cfg.clipped_level_step)
        if pcfg.use_predicted_step:
            step = _i32(torch.where(clipping_predicted, predicted_step, step))
            act = act | clipping_predicted
    monos = mono_handle_clipping(cfg, st.monos, step[:, None], act[:, None])
    frames_since = torch.where(
        act, 0, torch.clamp(st.frames_since_clipped + waiting.to(_I32),
                            max=cfg.clipped_wait_frames))
    if pred is not None:
        # Reset() on a clipping action: the ring starts over.
        fresh = init_clipping_predictor(pred.averages.shape[1],
                                        cfg.clipping_predictor,
                                        pred.tail.shape[0], audio.device)
        pred = tree_where(act, fresh, pred)
    st = st.replace(monos=monos, frames_since_clipped=_i32(frames_since),
                    predictor=pred)
    return _aggregate(cfg, st)


def recommend_input_volume(cfg: InputVolumeControllerConfig, st,
                           speech_probability, speech_level_dbfs,
                           has_speech_level):
    """RecommendInputVolume (input_volume_controller.cc:520-557); inputs
    (B,). Returns (state, recommended volume (B,) int32, valid (B,))."""
    valid = st.applied_input_volume >= 0
    st = _aggregate(cfg, st)
    rms_error = get_speech_level_rms_error_db(
        speech_level_dbfs, cfg.target_range_min_dbfs,
        cfg.target_range_max_dbfs)
    monos = mono_process(cfg, st.monos, rms_error[:, None],
                         has_speech_level[:, None],
                         speech_probability[:, None])
    # Only commit the Process results when the applied volume was set.
    monos = tree_where(valid, monos, st.monos)
    st = _aggregate(cfg, st.replace(monos=monos))
    st = st.replace(applied_input_volume=torch.full_like(
        st.applied_input_volume, -1))
    return st, st.recommended_input_volume, valid
