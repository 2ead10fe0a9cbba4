"""AgcManagerDirect: the hybrid analog AGC (input volume and compression).

Port of ``webrtc_audio_processing_tpu/models/agc1/agc_manager_direct.py``
(reference: agc/agc_manager_direct.{h,cc}, agc/agc.cc,
agc/loudness_histogram.cc, agc/utility.cc). Each capture channel's
MonoAgc owns an ``Agc``, a loudness histogram fed by the analytics VAD's
30 ms RMS and probabilities, and drives the recommended input volume
through AGC2's gain map and AGC1's digital compression gain (2..18 dB,
slewed by 0.05 dB a frame). The decisions are ``torch.where`` lattices
over the (B, C) monos, run as B * C rows; the analytics VAD
(``models/vad/analytics_vad.py``) does the heavy DSP on phase 2 of 3.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from webrtc_audio_processing_tpu_torch.models.agc1.gain_control import (
    flatten_channels,
    unflatten_channels,
)
from webrtc_audio_processing_tpu_torch.models.agc2.input_volume_controller import (  # noqa: E501
    compute_volume_update,
)
from webrtc_audio_processing_tpu_torch.models.vad import analytics_vad
from webrtc_audio_processing_tpu_torch.ops.batch import const, tree_where

I32 = torch.int32
F32 = torch.float32

# agc_manager_direct.cc:36-66.
LEVEL_QUANTIZATION_SLACK = 25
DEFAULT_COMPRESSION_GAIN = 7
MAX_COMPRESSION_GAIN = 12
MIN_COMPRESSION_GAIN = 2
COMPRESSION_GAIN_STEP = 0.05
MAX_MIC_LEVEL = 255
MIN_MIC_LEVEL = 12
MAX_RESIDUAL_GAIN_CHANGE = 15
SURPLUS_COMPRESSION_GAIN = 6
OVERRIDE_TARGET_SPEECH_LEVEL_DBFS = -18.0
OVERRIDE_SPEECH_PROB_SILENCE_THRESHOLD = 0.5
OVERRIDE_WAIT_FRAMES = 0

# agc.cc:25-29.
DEFAULT_LEVEL_DBFS = -18
NUM_ANALYSIS_FRAMES = 100
ACTIVITY_THRESHOLD = 0.3

# utility.cc: loudness conversions.
_LN10 = float(np.log(10.0))
LINEAR2DB_SCALE = 20.0 / _LN10
LINEAR2LOUDNESS_SCALE = 13.4 / _LN10


def dbfs2loudness(dbfs: float) -> float:
    return (90.0 + dbfs) * LINEAR2LOUDNESS_SCALE / LINEAR2DB_SCALE


def loudness2db(loudness):
    return loudness * LINEAR2DB_SCALE / LINEAR2LOUDNESS_SCALE


def linear2loudness(rms):
    return torch.where(rms == 0.0, -15.0, LINEAR2LOUDNESS_SCALE
                       * torch.log(torch.clamp(rms, min=1e-30)))


# LoudnessHistogram (loudness_histogram.cc:21-49): the bin centers
# 10^((n - 15) / 13.4), 1 dB steps in the 13.4-scaled loudness domain.
HIST_SIZE = 77
HIST_BIN_CENTERS = np.power(10.0, (np.arange(HIST_SIZE) - 15.0) / 13.4)
LOG_DOMAIN_MIN_BIN_CENTER = -2.57752062648587
LOG_DOMAIN_STEP_INV = 5.81954605750359
PROB_Q_DOMAIN = 1024.0
TRANSIENT_WIDTH_THRESHOLD = 7
LOW_PROB_THRESHOLD_Q10 = int(0.2 * PROB_Q_DOMAIN)
HIST_WINDOW = NUM_ANALYSIS_FRAMES  # a circular window of 100 frames


class _State:
    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


_CENTERS = tuple(float(v) for v in HIST_BIN_CENTERS.astype(np.float32))


def _centers(device) -> torch.Tensor:
    return const(_CENTERS, F32, device)


@dataclass
class LoudnessHistogramState(_State):
    """LoudnessHistogram with a circular window; leaves (N, ...)."""

    bin_count_q10: torch.Tensor  # (N, 77) int32
    audio_content_q10: torch.Tensor  # (N,) int32
    num_updates: torch.Tensor  # (N,) int32
    activity_probability: torch.Tensor  # (N, window) int32
    hist_bin_index: torch.Tensor  # (N, window) int32
    buffer_index: torch.Tensor  # (N,) int32
    buffer_is_full: torch.Tensor  # (N,) bool
    len_high_activity: torch.Tensor  # (N,) int32


def init_histogram(batch: int, device,
                   window_size: int = HIST_WINDOW) -> LoudnessHistogramState:
    """LoudnessHistogram::Create(window_size) (loudness_histogram.cc:
    171-181); ``window_size`` 0 is the non-circular variant."""
    z = lambda *s: torch.zeros((batch,) + s, dtype=I32,  # noqa: E731
                               device=device)
    return LoudnessHistogramState(
        bin_count_q10=z(HIST_SIZE),
        audio_content_q10=z(),
        num_updates=z(),
        activity_probability=z(window_size),
        hist_bin_index=z(window_size),
        buffer_index=z(),
        buffer_is_full=torch.zeros(batch, dtype=torch.bool, device=device),
        len_high_activity=z(),
    )


def _get_bin_index(rms):
    """GetBinIndex (loudness_histogram.cc:190-210)."""
    centers = _centers(rms.device)
    idx = torch.floor((torch.log(torch.clamp(rms, min=1e-30))
                       - LOG_DOMAIN_MIN_BIN_CENTER)
                      * LOG_DOMAIN_STEP_INV).to(I32)
    idx = torch.clamp(idx, 0, HIST_SIZE - 2).long()
    b = 0.5 * (centers[idx] + centers[idx + 1])
    idx = torch.where(rms > b, idx + 1, idx)
    idx = torch.where(rms <= centers[0], 0, idx)
    idx = torch.where(rms >= centers[-1], HIST_SIZE - 1, idx)
    return idx.to(I32)


def _add_at(x, idx, val):
    """x[n, idx[n, ...]] += val[n, ...] (duplicates accumulate)."""
    if idx.dim() == 1:
        idx, val = idx[:, None], val[:, None]
    return x.scatter_add(1, idx.long(), val.to(x.dtype))


def histogram_update(st: LoudnessHistogramState, rms, prob):
    """Update (loudness_histogram.cc:93-160) with the transient removal.
    rms, prob: (N,) float."""
    dev = rms.device
    window = st.activity_probability.shape[1]
    hist_index = _get_bin_index(rms)
    prob_q10 = torch.floor(prob * PROB_Q_DOMAIN).to(I32)
    if window == 0:
        return st.replace(
            bin_count_q10=_add_at(st.bin_count_q10, hist_index, prob_q10),
            audio_content_q10=st.audio_content_q10 + prob_q10,
            num_updates=st.num_updates + 1)

    # Remove the oldest entry when the window is full.
    bidx = st.buffer_index.long()[:, None]
    old_prob = torch.gather(st.activity_probability, 1, bidx)[:, 0]
    old_bin = torch.gather(st.hist_bin_index, 1, bidx)[:, 0]
    removed = torch.where(st.buffer_is_full, old_prob, 0)
    bc = _add_at(st.bin_count_q10, old_bin, -removed)
    content = st.audio_content_q10 - removed

    low = prob_q10 <= LOW_PROB_THRESHOLD_Q10
    # Transient removal: a low-probability frame after a short (<= 7)
    # high-activity run erases the run's contributions.
    do_remove = low & (st.len_high_activity <= TRANSIENT_WIDTH_THRESHOLD)
    back = torch.arange(TRANSIENT_WIDTH_THRESHOLD, device=dev)
    idxs = torch.remainder(st.buffer_index.long()[:, None] - 1 - back,
                           window)
    act = do_remove[:, None] & (back < st.len_high_activity[:, None])
    probs_back = torch.gather(st.activity_probability, 1, idxs)
    bins_back = torch.gather(st.hist_bin_index, 1, idxs)
    bc = _add_at(bc, bins_back, torch.where(act, -probs_back, 0))
    content = content - torch.sum(torch.where(act, probs_back, 0), 1,
                                  dtype=I32)
    new_act_prob = st.activity_probability.scatter(
        1, idxs, torch.where(act, 0, probs_back))

    prob_q10 = torch.where(low, 0, prob_q10)
    len_high = torch.where(
        low, 0, torch.where(st.len_high_activity
                            <= TRANSIENT_WIDTH_THRESHOLD,
                            st.len_high_activity + 1,
                            st.len_high_activity)).to(I32)
    new_act_prob = new_act_prob.scatter(1, bidx, prob_q10[:, None])
    new_bins = st.hist_bin_index.scatter(1, bidx, hist_index[:, None])
    nb_index = st.buffer_index + 1
    full = st.buffer_is_full | (nb_index >= window)
    bc = _add_at(bc, hist_index, prob_q10)
    return st.replace(
        bin_count_q10=bc,
        audio_content_q10=content + prob_q10,
        num_updates=st.num_updates + 1,
        activity_probability=new_act_prob,
        hist_bin_index=new_bins,
        buffer_index=torch.remainder(nb_index, window).to(I32),
        buffer_is_full=full,
        len_high_activity=len_high,
    )


def histogram_current_rms(st: LoudnessHistogramState):
    """CurrentRms (loudness_histogram.cc:213-227)."""
    centers = _centers(st.bin_count_q10.device)
    total = st.audio_content_q10.to(F32)
    mean = torch.sum(st.bin_count_q10.to(F32) * centers, 1) / torch.clamp(
        total, min=1.0)
    return torch.where(st.audio_content_q10 > 0, mean, centers[0])


def histogram_reset(st: LoudnessHistogramState) -> LoudnessHistogramState:
    z = torch.zeros_like(st.audio_content_q10)
    return st.replace(
        bin_count_q10=torch.zeros_like(st.bin_count_q10),
        audio_content_q10=z, num_updates=z, buffer_index=z,
        buffer_is_full=torch.zeros_like(st.buffer_is_full),
        len_high_activity=z)


# ------------------------------------------------------------------ Agc


TARGET_LEVEL_LOUDNESS = dbfs2loudness(DEFAULT_LEVEL_DBFS)


@dataclass
class AgcState(_State):
    """Agc (agc.{h,cc}): the analytics VAD and the loudness histogram."""

    vad: analytics_vad.VoiceActivityDetectorState
    histogram: LoudnessHistogramState


def init_agc(batch: int, device) -> AgcState:
    return AgcState(
        vad=analytics_vad.init_voice_activity_detector(batch, device),
        histogram=init_histogram(batch, device))


def agc_process(st: AgcState, frame, phase: int):
    """Agc::Process and GetRmsErrorDb (agc.cc:42-80).

    frame: (N, 160) int32 16 kHz samples; phase: the static frame index
    mod 3. Returns (state, rms_error (N,), update_gain (N,) bool,
    voice_probability (N,))."""
    vad, probs, rms, _ = analytics_vad.process_chunk(st.vad, frame, phase)
    hist = st.histogram
    if phase == 2:
        for i in range(3):
            hist = histogram_update(hist, rms[:, i], probs[:, i])
    enough = (hist.num_updates >= NUM_ANALYSIS_FRAMES) & (
        hist.audio_content_q10.to(F32) / PROB_Q_DOMAIN
        > NUM_ANALYSIS_FRAMES * ACTIVITY_THRESHOLD)
    loudness = linear2loudness(histogram_current_rms(hist))
    error = torch.floor(loudness2db(TARGET_LEVEL_LOUDNESS - loudness)
                        + 0.5).to(I32)
    hist = tree_where(enough, histogram_reset(hist), hist)
    return (st.replace(vad=vad, histogram=hist), error, enough,
            vad.last_probability)


# -------------------------------------------------------------- MonoAgc


@dataclass
class MonoAgcState(_State):
    agc: AgcState
    level: torch.Tensor  # (N,) int32
    max_level: torch.Tensor
    max_compression_gain: torch.Tensor
    target_compression: torch.Tensor
    compression: torch.Tensor
    compression_accumulator: torch.Tensor  # (N,) float32
    recommended_input_volume: torch.Tensor  # (N,) int32
    check_volume_on_next_process: torch.Tensor  # (N,) bool
    startup: torch.Tensor  # (N,) bool
    frames_since_update_gain: torch.Tensor  # (N,) int32
    is_first_frame: torch.Tensor  # (N,) bool
    new_compression_valid: torch.Tensor  # (N,) bool
    new_compression: torch.Tensor  # (N,) int32


def init_mono_agc(batch: int, device,
                  disable_digital_adaptive: bool = False) -> MonoAgcState:
    comp = 0 if disable_digital_adaptive else DEFAULT_COMPRESSION_GAIN

    def full(v, dtype=I32):
        return torch.full((batch,), v, dtype=dtype, device=device)

    return MonoAgcState(
        agc=init_agc(batch, device),
        level=full(0),
        max_level=full(MAX_MIC_LEVEL),
        max_compression_gain=full(MAX_COMPRESSION_GAIN),
        target_compression=full(comp),
        compression=full(comp),
        compression_accumulator=full(float(comp), F32),
        recommended_input_volume=full(0),
        check_volume_on_next_process=full(True, torch.bool),
        startup=full(True, torch.bool),
        frames_since_update_gain=full(0),
        is_first_frame=full(True, torch.bool),
        new_compression_valid=full(False, torch.bool),
        new_compression=full(comp),
    )


def _agc_reset(st: MonoAgcState) -> MonoAgcState:
    return st.replace(agc=st.agc.replace(
        histogram=histogram_reset(st.agc.histogram)))


def _set_max_level(st: MonoAgcState, level, clipped_level_min: int):
    """SetMaxLevel (agc_manager_direct.cc:305-315)."""
    max_comp = MAX_COMPRESSION_GAIN + torch.floor(
        (1.0 * MAX_MIC_LEVEL - level.to(F32))
        / (MAX_MIC_LEVEL - clipped_level_min) * SURPLUS_COMPRESSION_GAIN
        + 0.5).to(I32)
    return st.replace(max_level=level, max_compression_gain=max_comp)


def _set_level(st: MonoAgcState, new_level):
    """SetLevel (agc_manager_direct.cc:266-303)."""
    voe = st.recommended_input_volume
    invalid = voe == 0
    manual = ((voe > st.level + LEVEL_QUANTIZATION_SLACK)
              | (voe < st.level - LEVEL_QUANTIZATION_SLACK))
    man_st = st.replace(
        level=voe,
        max_level=torch.maximum(st.max_level, voe),
        agc=st.agc.replace(histogram=histogram_reset(st.agc.histogram)),
        frames_since_update_gain=torch.zeros_like(voe),
        is_first_frame=torch.zeros_like(st.is_first_frame),
    )
    clamped = torch.minimum(new_level, st.max_level)
    take = ~invalid & ~manual & (clamped != st.level)
    norm_st = st.replace(
        recommended_input_volume=torch.where(take, clamped, voe),
        level=torch.where(take, clamped, st.level))
    return tree_where(~invalid & manual, man_st, norm_st)


def mono_agc_process(st: MonoAgcState, frame, phase: int,
                     clipped_level_min: int, min_mic_level: int,
                     disable_digital_adaptive: bool, rms_error_override=None,
                     has_override=None):
    """MonoAgc::Process (agc_manager_direct.cc:195-236). Returns (state,
    voice_probability (N,))."""
    # CheckVolumeAndReset (:329-355).
    vol = st.recommended_input_volume
    skip = (vol == 0) & ~st.startup
    raised = torch.clamp(vol, min=min_mic_level)
    checked = st.replace(
        recommended_input_volume=torch.where(skip, vol, raised),
        level=torch.where(skip, st.level, raised),
        startup=st.startup & skip,
        frames_since_update_gain=torch.where(
            skip, st.frames_since_update_gain, 0).to(I32),
        is_first_frame=st.is_first_frame | ~skip,
        agc=st.agc.replace(histogram=tree_where(
            skip, st.agc.histogram, histogram_reset(st.agc.histogram))),
    )
    st = tree_where(st.check_volume_on_next_process, checked, st)
    st = st.replace(check_volume_on_next_process=torch.zeros_like(
        st.check_volume_on_next_process))

    agc, rms_error, update_gain, voice_prob = agc_process(st.agc, frame,
                                                          phase)
    st = st.replace(agc=agc)

    if has_override is not None:
        blocked = st.is_first_frame | (st.frames_since_update_gain
                                       < OVERRIDE_WAIT_FRAMES)
        use_ovr = has_override & ~blocked
        rms_error = torch.where(use_ovr, rms_error_override, rms_error)
        update_gain = torch.where(has_override, use_ovr, update_gain)

    # UpdateGain (agc_manager_direct.cc:357-397).
    rms2 = rms_error + MIN_COMPRESSION_GAIN
    raw_comp = torch.minimum(torch.clamp(rms2, min=MIN_COMPRESSION_GAIN),
                             st.max_compression_gain)
    snap = (((raw_comp == st.max_compression_gain)
             & (st.target_compression == st.max_compression_gain - 1))
            | ((raw_comp == MIN_COMPRESSION_GAIN)
               & (st.target_compression == MIN_COMPRESSION_GAIN + 1)))
    new_target = torch.where(
        snap, raw_comp,
        (raw_comp - st.target_compression) // 2 + st.target_compression)
    residual = torch.clamp(rms2 - raw_comp, -MAX_RESIDUAL_GAIN_CHANGE,
                           MAX_RESIDUAL_GAIN_CHANGE)
    new_level = compute_volume_update(residual, st.level, min_mic_level)

    upd = st.replace(target_compression=new_target.to(I32),
                     frames_since_update_gain=torch.zeros_like(st.level))
    upd_lv = _set_level(upd, new_level)
    level_changed = upd_lv.level != st.level
    upd_lv = tree_where(level_changed & (residual != 0), _agc_reset(upd_lv),
                        upd_lv)
    upd_final = tree_where(residual == 0, upd, upd_lv)
    st = tree_where(update_gain, upd_final, st)

    # UpdateCompressor (agc_manager_direct.cc:399-424).
    new_comp_valid = torch.zeros_like(st.new_compression_valid)
    if not disable_digital_adaptive:
        differs = st.compression != st.target_compression
        acc = st.compression_accumulator + torch.where(
            st.target_compression > st.compression, COMPRESSION_GAIN_STEP,
            -COMPRESSION_GAIN_STEP)
        nearest = torch.floor(acc + 0.5).to(I32)
        snap2 = torch.abs(acc - nearest.to(F32)) < (
            COMPRESSION_GAIN_STEP / 2)
        new_comp = torch.where(snap2, nearest, st.compression)
        changed = differs & (new_comp != st.compression)
        st = st.replace(
            compression=torch.where(differs, new_comp, st.compression),
            compression_accumulator=torch.where(
                differs, torch.where(changed, new_comp.to(F32), acc),
                st.compression_accumulator))
        new_comp_valid = changed

    st = st.replace(
        is_first_frame=torch.zeros_like(st.is_first_frame),
        frames_since_update_gain=torch.clamp(
            st.frames_since_update_gain + 1, max=OVERRIDE_WAIT_FRAMES + 1),
        new_compression_valid=new_comp_valid,
        new_compression=st.compression)
    return st, voice_prob


def mono_handle_clipping(st: MonoAgcState, step: int, clipped_level_min: int,
                         do_it):
    """HandleClipping (agc_manager_direct.cc:238-264)."""
    new_max = torch.clamp(st.max_level - step, min=clipped_level_min)
    with_max = _set_max_level(st, new_max, clipped_level_min)
    adjust = st.level > clipped_level_min
    target = torch.clamp(st.level - step, min=clipped_level_min)
    adj = _agc_reset(_set_level(with_max, target)).replace(
        frames_since_update_gain=torch.zeros_like(st.level),
        is_first_frame=torch.zeros_like(st.is_first_frame))
    return tree_where(do_it, tree_where(adjust, adj, with_max), st)


# ------------------------------------------------------ AgcManagerDirect


@dataclass
class AgcManagerDirectState(_State):
    monos: MonoAgcState  # leaves (B, C, ...)
    frames_since_clipped: torch.Tensor  # (B,) int32
    recommended_input_volume: torch.Tensor  # (B,) int32


def init_state(num_channels: int, batch: int, device,
               clipped_wait_frames: int = 300) -> AgcManagerDirectState:
    monos = unflatten_channels(
        init_mono_agc(batch * num_channels, device), batch, num_channels)
    return AgcManagerDirectState(
        monos=monos,
        frames_since_clipped=torch.full((batch,), clipped_wait_frames,
                                        dtype=I32, device=device),
        recommended_input_volume=torch.zeros(batch, dtype=I32,
                                             device=device),
    )


def _aggregate(st: AgcManagerDirectState):
    """AggregateChannelLevels (agc_manager_direct.cc:699-724)."""
    return st.replace(recommended_input_volume=torch.amin(
        st.monos.recommended_input_volume, 1))


def set_stream_analog_level(st: AgcManagerDirectState, level):
    """set_stream_analog_level (agc_manager_direct.cc:687-697); ``level``
    an int or a (B,) tensor."""
    rec = st.monos.recommended_input_volume
    if torch.is_tensor(level):
        lv = level.to(I32)
        lv = (lv[:, None] if lv.dim() == 1 else lv).expand_as(rec).clone()
    else:
        lv = torch.full_like(rec, int(level))
    return _aggregate(st.replace(monos=st.monos.replace(
        recommended_input_volume=lv)))


def analyze_pre_process(st: AgcManagerDirectState, audio,
                        clipped_level_step: int = 15,
                        clipped_ratio_threshold: float = 0.1,
                        clipped_wait_frames: int = 300,
                        clipped_level_min: int = 70):
    """AnalyzePreProcess (agc_manager_direct.cc:545-621) without the
    clipping predictor (analog_config.clipping_predictor.enabled is false
    by default). audio: (B, L, C) float."""
    st = _aggregate(st)
    B, C = st.monos.level.shape
    clipped = (audio >= 32767.0) | (audio <= -32768.0)
    ratio = torch.amax(torch.mean(clipped.to(F32), 1), 1)
    waiting = st.frames_since_clipped < clipped_wait_frames
    detected = ~waiting & (ratio > clipped_ratio_threshold)
    monos = mono_handle_clipping(flatten_channels(st.monos),
                                 clipped_level_step, clipped_level_min,
                                 detected.repeat_interleave(C, 0))
    frames = torch.where(
        detected, 0,
        torch.clamp(st.frames_since_clipped + waiting.to(I32),
                    max=clipped_wait_frames)).to(I32)
    st = st.replace(monos=unflatten_channels(monos, B, C),
                    frames_since_clipped=frames)
    return _aggregate(st)


def process(st: AgcManagerDirectState, band0, phase: int,
            clipped_level_min: int = 70, min_mic_level: int = MIN_MIC_LEVEL,
            disable_digital_adaptive: bool = False,
            speech_probability=None, speech_level_dbfs=None):
    """Process (agc_manager_direct.cc:624-658).

    band0: (B, 160, C) int32, split band 0 at 16 kHz; phase: the static
    frame index mod 3. Returns (state, recommended_volume (B,),
    compression_gain (B,), voice_probability (B,))."""
    st = _aggregate(st)
    B, C = st.monos.level.shape
    ovr = has_ovr = None
    if speech_probability is not None and speech_level_dbfs is not None:
        ovr = torch.where(
            speech_probability < OVERRIDE_SPEECH_PROB_SILENCE_THRESHOLD, 0,
            torch.round(OVERRIDE_TARGET_SPEECH_LEVEL_DBFS - torch.clamp(
                speech_level_dbfs, -90.0, 30.0)).to(I32)).to(I32)
        ovr = ovr.expand(B).repeat_interleave(C, 0)
        has_ovr = torch.ones_like(ovr, dtype=torch.bool)
    frames = band0.permute(0, 2, 1).reshape(B * C, -1)
    monos, vps = mono_agc_process(
        flatten_channels(st.monos), frames, phase, clipped_level_min,
        min_mic_level, disable_digital_adaptive, ovr, has_ovr)
    monos = unflatten_channels(monos, B, C)
    st = _aggregate(st.replace(monos=monos))
    # The compression of the channel that controls the gain (min volume).
    ctrl = torch.argmin(monos.recommended_input_volume, 1, keepdim=True)
    compression = torch.gather(monos.new_compression, 1, ctrl)[:, 0]
    return (st, st.recommended_input_volume, compression,
            torch.amax(vps.reshape(B, C), 1))


class AgcManagerDirect(nn.Module):
    """The hybrid AGC's manager for one analog-controller config."""

    def __init__(self, clipped_level_min: int = 70,
                 min_mic_level: int = MIN_MIC_LEVEL,
                 disable_digital_adaptive: bool = False):
        super().__init__()
        self.clipped_level_min = clipped_level_min
        self.min_mic_level = min_mic_level
        self.disable_digital_adaptive = disable_digital_adaptive

    def forward(self, state: AgcManagerDirectState, band0, phase: int):
        return process(state, band0, phase, self.clipped_level_min,
                       self.min_mic_level, self.disable_digital_adaptive)
