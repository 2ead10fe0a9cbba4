"""Field trials and the AEC3 config adjustment they drive.

Port of ``webrtc_audio_processing_tpu/field_trials.py``, a host module: the
string-keyed ``FieldTrials`` registry (reference: webrtc/api/field_trials.h,
webrtc/experiments/registered_field_trials.h) and AEC3's ``AdjustConfig``
(reference: modules/audio_processing/aec3/echo_canceller3.cc:279-700) over
the port's ``models/aec3/config.EchoCanceller3Config``. Every adjustment
happens on the host before the pipeline is built, so a trial costs nothing
on the device.
"""

from __future__ import annotations

import dataclasses as dc

__all__ = ["FieldTrials", "adjust_aec3_config", "REGISTERED_FIELD_TRIALS"]


# Subset of webrtc/experiments/registered_field_trials.h relevant to APM
# (the reference validates unknown keys in debug builds; we do the same on
# construction with strict=True).
REGISTERED_FIELD_TRIALS = frozenset([
    "WebRTC-Aec3AntiHowlingMinimizationKillSwitch",
    "WebRTC-Aec3ClampInstQualityToOneKillSwitch",
    "WebRTC-Aec3ClampInstQualityToZeroKillSwitch",
    "WebRTC-Aec3ConservativeTailFreqResponse",
    "WebRTC-Aec3DelayEstimateSmoothingDelayFoundOverride",
    "WebRTC-Aec3EchoSaturationDetectionKillSwitch",
    "WebRTC-Aec3EnforceCaptureDelayEstimationDownmixing",
    "WebRTC-Aec3EnforceCaptureDelayEstimationLeftRightPrioritization",
    "WebRTC-Aec3EnforceConservativeHfSuppression",
    "WebRTC-Aec3EnforceLowActiveRenderLimit",
    "WebRTC-Aec3EnforceMoreTransparentNearendSuppressorHfTuning",
    "WebRTC-Aec3EnforceMoreTransparentNearendSuppressorTuning",
    "WebRTC-Aec3EnforceMoreTransparentNormalSuppressorHfTuning",
    "WebRTC-Aec3EnforceMoreTransparentNormalSuppressorTuning",
    "WebRTC-Aec3EnforceRapidlyAdjustingNearendSuppressorTunings",
    "WebRTC-Aec3EnforceRapidlyAdjustingNormalSuppressorTunings",
    "WebRTC-Aec3EnforceRenderDelayEstimationDownmixing",
    "WebRTC-Aec3EnforceSlowlyAdjustingNearendSuppressorTunings",
    "WebRTC-Aec3EnforceSlowlyAdjustingNormalSuppressorTunings",
    "WebRTC-Aec3EnforceStationarityProperties",
    "WebRTC-Aec3EnforceStationarityPropertiesAtInit",
    "WebRTC-Aec3EnforceVeryLowActiveRenderLimit",
    "WebRTC-Aec3HighPassFilterEchoReference",
    "WebRTC-Aec3MinErleDuringOnsetsKillSwitch",
    "WebRTC-Aec3NonlinearModeReverbKillSwitch",
    "WebRTC-Aec3OnsetDetectionKillSwitch",
    "WebRTC-Aec3RenderDelayEstimationLeftRightPrioritizationKillSwitch",
    "WebRTC-Aec3SensitiveDominantNearendActivation",
    "WebRTC-Aec3SetupSpecificDefaultConfigDefaultsKillSwitch",
    "WebRTC-Aec3ShortHeadroomKillSwitch",
    "WebRTC-Aec3StereoContentDetectionKillSwitch",
    "WebRTC-Aec3SuppressorTuningOverride",
    "WebRTC-Aec3TransparentAntiHowlingGain",
    "WebRTC-Aec3TransparentModeKillSwitch",
    "WebRTC-Aec3Use1Dot2SecondsInitialStateDuration",
    "WebRTC-Aec3Use1Dot6SecondsInitialStateDuration",
    "WebRTC-Aec3Use2Dot0SecondsInitialStateDuration",
    "WebRTC-Aec3UseDot1SecondsInitialStateDuration",
    "WebRTC-Aec3UseDot2SecondsInitialStateDuration",
    "WebRTC-Aec3UseDot3SecondsInitialStateDuration",
    "WebRTC-Aec3UseDot6SecondsInitialStateDuration",
    "WebRTC-Aec3UseDot9SecondsInitialStateDuration",
    "WebRTC-Aec3UseShortConfigChangeDuration",
    "WebRTC-Aec3UseZeroInitialStateDuration",
    "WebRTC-Aec3UseNearendReverbLen",
    "WebRTC-Aec3VerySensitiveDominantNearendActivation",
    "WebRTC-Aec3StereoContentDetection",
    "WebRTC-ApmExperimentalMultiChannelCaptureKillSwitch",
    "WebRTC-ApmExperimentalMultiChannelRenderKillSwitch",
    "WebRTC-Audio-Agc2-InputVolumeControllerConfigOverride",
    "WebRTC-Audio-GainController2",
    "WebRTC-Audio-Agc2-ClippingPredictorKillSwitch",
])


class FieldTrials:
    """String-keyed experiment registry (api/field_trials.h).

    The canonical encoding is the WebRTC trial string
    ``"TrialName/GroupName/OtherTrial/Enabled-p1:v1,p2:v2/"``.
    """

    def __init__(self, trials: str | dict | None = None,
                 strict: bool = False):
        self._map: dict[str, str] = {}
        if isinstance(trials, dict):
            self._map = dict(trials)
        elif trials:
            parts = trials.split("/")
            if parts[-1] == "":
                parts = parts[:-1]
            if len(parts) % 2 != 0:
                raise ValueError(f"uneven field trial string: {trials!r}")
            for key, group in zip(parts[::2], parts[1::2]):
                if not key or not group:
                    raise ValueError(f"empty field trial key/group: {trials!r}")
                if key in self._map and self._map[key] != group:
                    raise ValueError(f"conflicting groups for {key}")
                self._map[key] = group
        if strict:
            unknown = set(self._map) - REGISTERED_FIELD_TRIALS
            if unknown:
                raise ValueError(f"unregistered field trials: {sorted(unknown)}")

    def lookup(self, key: str) -> str:
        """FieldTrialsView::Lookup — group string, or '' if unset."""
        return self._map.get(key, "")

    def is_enabled(self, key: str) -> bool:
        return self.lookup(key).startswith("Enabled")

    def is_disabled(self, key: str) -> bool:
        return self.lookup(key).startswith("Disabled")

    def parse_params(self, key: str) -> dict[str, str]:
        """ParseFieldTrial-style 'Enabled-a:1,b:2' / 'a:1,b:2' param parse
        (rtc_base/experiments/field_trial_parser.cc semantics)."""
        group = self.lookup(key)
        if not group:
            return {}
        body = group.split("-", 1)[1] if (
            group.startswith(("Enabled-", "Disabled-"))
        ) else group
        out = {}
        for item in body.split(","):
            if ":" in item:
                k, v = item.split(":", 1)
                out[k.strip()] = v.strip()
        return out


def _float_param(params: dict, key: str, default: float) -> float:
    try:
        return float(params[key])
    except (KeyError, ValueError):
        return default


def _int_param(params: dict, key: str, default: int) -> int:
    try:
        return int(params[key])
    except (KeyError, ValueError):
        return default


def adjust_aec3_config(config, trials: FieldTrials):
    """AdjustConfig (aec3/echo_canceller3.cc:279-700): map field trials onto
    an EchoCanceller3Config. Pure host-side; returns a new config."""
    c = config
    rep = dc.replace

    def rep_supp(**kw):
        return rep(c, suppressor=rep(c.suppressor, **kw))

    if trials.is_enabled("WebRTC-Aec3StereoContentDetectionKillSwitch"):
        c = rep(c, multi_channel=rep(c.multi_channel,
                                     detect_stereo_content=False))
    if trials.is_enabled("WebRTC-Aec3AntiHowlingMinimizationKillSwitch"):
        c = rep_supp(high_bands_suppression=rep(
            c.suppressor.high_bands_suppression,
            anti_howling_activation_threshold=25.0, anti_howling_gain=0.01))
    if trials.is_enabled("WebRTC-Aec3UseShortConfigChangeDuration"):
        c = rep(c, filter=rep(c.filter, config_change_duration_blocks=10))

    for key, secs in [
        ("WebRTC-Aec3UseZeroInitialStateDuration", 0.0),
        ("WebRTC-Aec3UseDot1SecondsInitialStateDuration", 0.1),
        ("WebRTC-Aec3UseDot2SecondsInitialStateDuration", 0.2),
        ("WebRTC-Aec3UseDot3SecondsInitialStateDuration", 0.3),
        ("WebRTC-Aec3UseDot6SecondsInitialStateDuration", 0.6),
        ("WebRTC-Aec3UseDot9SecondsInitialStateDuration", 0.9),
        ("WebRTC-Aec3Use1Dot2SecondsInitialStateDuration", 1.2),
        ("WebRTC-Aec3Use1Dot6SecondsInitialStateDuration", 1.6),
        ("WebRTC-Aec3Use2Dot0SecondsInitialStateDuration", 2.0),
    ]:
        if trials.is_enabled(key):
            c = rep(c, filter=rep(c.filter, initial_state_seconds=secs))
            break

    if trials.is_enabled("WebRTC-Aec3HighPassFilterEchoReference"):
        c = rep(c, filter=rep(c.filter, high_pass_filter_echo_reference=True))
    if trials.is_enabled("WebRTC-Aec3EchoSaturationDetectionKillSwitch"):
        c = rep(c, ep_strength=rep(c.ep_strength, echo_can_saturate=False))

    reverb = trials.parse_params("WebRTC-Aec3UseNearendReverbLen")
    if reverb:
        default_len = _float_param(reverb, "default_len",
                                   c.ep_strength.default_len)
        nearend_len = _float_param(reverb, "nearend_len",
                                   c.ep_strength.nearend_len)
        if -1 < default_len < 1 and -1 < nearend_len < 1:
            c = rep(c, ep_strength=rep(c.ep_strength, default_len=default_len,
                                       nearend_len=nearend_len))

    if trials.is_enabled("WebRTC-Aec3ConservativeTailFreqResponse"):
        c = rep(c, ep_strength=rep(
            c.ep_strength, use_conservative_tail_frequency_response=True))
    if trials.is_disabled("WebRTC-Aec3ConservativeTailFreqResponse"):
        c = rep(c, ep_strength=rep(
            c.ep_strength, use_conservative_tail_frequency_response=False))
    if trials.is_enabled("WebRTC-Aec3ShortHeadroomKillSwitch"):
        c = rep(c, delay=rep(c.delay, delay_headroom_samples=128))
    if trials.is_enabled("WebRTC-Aec3ClampInstQualityToZeroKillSwitch"):
        c = rep(c, erle=rep(c.erle, clamp_quality_estimate_to_zero=False))
    if trials.is_enabled("WebRTC-Aec3ClampInstQualityToOneKillSwitch"):
        c = rep(c, erle=rep(c.erle, clamp_quality_estimate_to_one=False))
    if trials.is_enabled("WebRTC-Aec3OnsetDetectionKillSwitch"):
        c = rep(c, erle=rep(c.erle, onset_detection=False))

    if trials.is_enabled("WebRTC-Aec3EnforceRenderDelayEstimationDownmixing"):
        c = rep(c, delay=rep(c.delay, render_alignment_mixing=rep(
            c.delay.render_alignment_mixing, downmix=True,
            adaptive_selection=False)))
    if trials.is_enabled("WebRTC-Aec3EnforceCaptureDelayEstimationDownmixing"):
        c = rep(c, delay=rep(c.delay, capture_alignment_mixing=rep(
            c.delay.capture_alignment_mixing, downmix=True,
            adaptive_selection=False)))
    if trials.is_enabled(
            "WebRTC-Aec3EnforceCaptureDelayEstimationLeftRightPrioritization"):
        c = rep(c, delay=rep(c.delay, capture_alignment_mixing=rep(
            c.delay.capture_alignment_mixing,
            prefer_first_two_channels=True)))
    if trials.is_enabled(
            "WebRTC-Aec3RenderDelayEstimationLeftRightPrioritizationKillSwitch"
    ):
        c = rep(c, delay=rep(c.delay, capture_alignment_mixing=rep(
            c.delay.capture_alignment_mixing,
            prefer_first_two_channels=False)))

    if trials.is_enabled("WebRTC-Aec3SensitiveDominantNearendActivation"):
        c = rep_supp(dominant_nearend_detection=rep(
            c.suppressor.dominant_nearend_detection, enr_threshold=0.5))
    elif trials.is_enabled("WebRTC-Aec3VerySensitiveDominantNearendActivation"):
        c = rep_supp(dominant_nearend_detection=rep(
            c.suppressor.dominant_nearend_detection, enr_threshold=0.75))

    if trials.is_enabled("WebRTC-Aec3TransparentAntiHowlingGain"):
        c = rep_supp(high_bands_suppression=rep(
            c.suppressor.high_bands_suppression, anti_howling_gain=1.0))

    for key, which, mask, transparent, suppress in [
        ("WebRTC-Aec3EnforceMoreTransparentNormalSuppressorTuning",
         "normal_tuning", "mask_lf", 0.4, 0.5),
        ("WebRTC-Aec3EnforceMoreTransparentNearendSuppressorTuning",
         "nearend_tuning", "mask_lf", 1.29, 1.3),
        ("WebRTC-Aec3EnforceMoreTransparentNormalSuppressorHfTuning",
         "normal_tuning", "mask_hf", 0.3, 0.4),
        ("WebRTC-Aec3EnforceMoreTransparentNearendSuppressorHfTuning",
         "nearend_tuning", "mask_hf", 1.09, 1.1),
    ]:
        if trials.is_enabled(key):
            tuning = getattr(c.suppressor, which)
            c = rep_supp(**{which: rep(tuning, **{
                mask: rep(getattr(tuning, mask), enr_transparent=transparent,
                          enr_suppress=suppress)})})

    for key, which, field_name, value in [
        ("WebRTC-Aec3EnforceRapidlyAdjustingNormalSuppressorTunings",
         "normal_tuning", "max_inc_factor", 2.5),
        ("WebRTC-Aec3EnforceRapidlyAdjustingNearendSuppressorTunings",
         "nearend_tuning", "max_inc_factor", 2.5),
        ("WebRTC-Aec3EnforceSlowlyAdjustingNormalSuppressorTunings",
         "normal_tuning", "max_dec_factor_lf", 0.2),
        ("WebRTC-Aec3EnforceSlowlyAdjustingNearendSuppressorTunings",
         "nearend_tuning", "max_dec_factor_lf", 0.2),
    ]:
        if trials.is_enabled(key):
            tuning = getattr(c.suppressor, which)
            c = rep_supp(**{which: rep(tuning, **{field_name: value})})

    if trials.is_enabled("WebRTC-Aec3EnforceConservativeHfSuppression"):
        c = rep_supp(conservative_hf_suppression=True)
    if trials.is_enabled("WebRTC-Aec3EnforceStationarityProperties"):
        c = rep(c, echo_audibility=rep(c.echo_audibility,
                                       use_stationarity_properties=True))
    if trials.is_enabled("WebRTC-Aec3EnforceStationarityPropertiesAtInit"):
        c = rep(c, echo_audibility=rep(
            c.echo_audibility, use_stationarity_properties_at_init=True))
    if trials.is_enabled("WebRTC-Aec3EnforceLowActiveRenderLimit"):
        c = rep(c, render_levels=rep(c.render_levels,
                                     active_render_limit=50.0))
    elif trials.is_enabled("WebRTC-Aec3EnforceVeryLowActiveRenderLimit"):
        c = rep(c, render_levels=rep(c.render_levels,
                                     active_render_limit=30.0))
    if trials.is_enabled("WebRTC-Aec3NonlinearModeReverbKillSwitch"):
        c = rep(c, echo_model=rep(c.echo_model,
                                  model_reverb_in_nonlinear_mode=False))

    # Whole-suppressor tuning override (echo_canceller3.cc:481-700).
    override = trials.parse_params("WebRTC-Aec3SuppressorTuningOverride")
    if override:
        def tune(which):
            t = getattr(c.suppressor, which)
            p = which.split("_")[0]  # 'nearend' / 'normal'
            return rep(
                t,
                mask_lf=rep(
                    t.mask_lf,
                    enr_transparent=_float_param(
                        override, f"{p}_tuning_mask_lf_enr_transparent",
                        t.mask_lf.enr_transparent),
                    enr_suppress=_float_param(
                        override, f"{p}_tuning_mask_lf_enr_suppress",
                        t.mask_lf.enr_suppress),
                ),
                mask_hf=rep(
                    t.mask_hf,
                    enr_transparent=_float_param(
                        override, f"{p}_tuning_mask_hf_enr_transparent",
                        t.mask_hf.enr_transparent),
                    enr_suppress=_float_param(
                        override, f"{p}_tuning_mask_hf_enr_suppress",
                        t.mask_hf.enr_suppress),
                ),
                max_inc_factor=_float_param(
                    override, f"{p}_tuning_max_inc_factor", t.max_inc_factor),
                max_dec_factor_lf=_float_param(
                    override, f"{p}_tuning_max_dec_factor_lf",
                    t.max_dec_factor_lf),
            )

        dnd = c.suppressor.dominant_nearend_detection
        c = rep_supp(
            nearend_tuning=tune("nearend_tuning"),
            normal_tuning=tune("normal_tuning"),
            dominant_nearend_detection=rep(
                dnd,
                enr_threshold=_float_param(
                    override, "dominant_nearend_detection_enr_threshold",
                    dnd.enr_threshold),
                enr_exit_threshold=_float_param(
                    override, "dominant_nearend_detection_enr_exit_threshold",
                    dnd.enr_exit_threshold),
                snr_threshold=_float_param(
                    override, "dominant_nearend_detection_snr_threshold",
                    dnd.snr_threshold),
                hold_duration=_int_param(
                    override, "dominant_nearend_detection_hold_duration",
                    dnd.hold_duration),
                trigger_threshold=_int_param(
                    override, "dominant_nearend_detection_trigger_threshold",
                    dnd.trigger_threshold),
            ),
        )
    return c
