"""EchoCanceller3 configuration tree.

Port of ``webrtc_audio_processing_tpu/models/aec3/config.py`` (reference:
api/audio/echo_canceller3_config.{h,cc}): the nested tuning struct with its
defaults, ``validate`` clamping and the default multichannel variant, as
frozen dataclasses. The port keeps its own copy; a test walks both trees.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class Buffering:
    excess_render_detection_interval_blocks: int = 250
    max_allowed_excess_render_blocks: int = 8


@dataclass(frozen=True)
class AlignmentMixing:
    downmix: bool = False
    adaptive_selection: bool = True
    activity_power_threshold: float = 10000.0
    prefer_first_two_channels: bool = True


@dataclass(frozen=True)
class DelaySelectionThresholds:
    initial: int = 5
    converged: int = 20


@dataclass(frozen=True)
class Delay:
    default_delay: int = 5
    down_sampling_factor: int = 4
    num_filters: int = 5
    delay_headroom_samples: int = 32
    hysteresis_limit_blocks: int = 1
    fixed_capture_delay_samples: int = 0
    delay_estimate_smoothing: float = 0.7
    delay_estimate_smoothing_delay_found: float = 0.7
    delay_candidate_detection_threshold: float = 0.2
    delay_selection_thresholds: DelaySelectionThresholds = field(
        default_factory=DelaySelectionThresholds
    )
    use_external_delay_estimator: bool = False
    log_warning_on_delay_changes: bool = False
    render_alignment_mixing: AlignmentMixing = field(
        default_factory=lambda: AlignmentMixing(prefer_first_two_channels=True)
    )
    capture_alignment_mixing: AlignmentMixing = field(
        default_factory=lambda: AlignmentMixing(prefer_first_two_channels=False)
    )
    detect_pre_echo: bool = True


@dataclass(frozen=True)
class RefinedConfiguration:
    length_blocks: int = 13
    leakage_converged: float = 0.00005
    leakage_diverged: float = 0.05
    error_floor: float = 0.001
    error_ceil: float = 2.0
    noise_gate: float = 20075344.0


@dataclass(frozen=True)
class CoarseConfiguration:
    length_blocks: int = 13
    rate: float = 0.7
    noise_gate: float = 20075344.0


@dataclass(frozen=True)
class Filter:
    refined: RefinedConfiguration = field(default_factory=RefinedConfiguration)
    coarse: CoarseConfiguration = field(default_factory=CoarseConfiguration)
    refined_initial: RefinedConfiguration = field(
        default_factory=lambda: RefinedConfiguration(
            length_blocks=12,
            leakage_converged=0.005,
            leakage_diverged=0.5,
        )
    )
    coarse_initial: CoarseConfiguration = field(
        default_factory=lambda: CoarseConfiguration(length_blocks=12, rate=0.9)
    )
    config_change_duration_blocks: int = 250
    initial_state_seconds: float = 2.5
    coarse_reset_hangover_blocks: int = 25
    conservative_initial_phase: bool = False
    enable_coarse_filter_output_usage: bool = True
    use_linear_filter: bool = True
    high_pass_filter_echo_reference: bool = False
    export_linear_aec_output: bool = False


@dataclass(frozen=True)
class Erle:
    min: float = 1.0
    max_l: float = 4.0
    max_h: float = 1.5
    onset_detection: bool = True
    num_sections: int = 1
    clamp_quality_estimate_to_zero: bool = True
    clamp_quality_estimate_to_one: bool = True


@dataclass(frozen=True)
class EpStrength:
    default_gain: float = 1.0
    default_len: float = 0.83
    nearend_len: float = 0.83
    echo_can_saturate: bool = True
    bounded_erl: bool = False
    erle_onset_compensation_in_dominant_nearend: bool = False
    use_conservative_tail_frequency_response: bool = True


@dataclass(frozen=True)
class EchoAudibility:
    low_render_limit: float = 4 * 64.0
    normal_render_limit: float = 64.0
    floor_power: float = 2 * 64.0
    audibility_threshold_lf: float = 10.0
    audibility_threshold_mf: float = 10.0
    audibility_threshold_hf: float = 10.0
    use_stationarity_properties: bool = False
    use_stationarity_properties_at_init: bool = False


@dataclass(frozen=True)
class RenderLevels:
    active_render_limit: float = 100.0
    poor_excitation_render_limit: float = 150.0
    poor_excitation_render_limit_ds8: float = 20.0
    render_power_gain_db: float = 0.0


@dataclass(frozen=True)
class EchoRemovalControl:
    has_clock_drift: bool = False
    linear_and_stable_echo_path: bool = False


@dataclass(frozen=True)
class EchoModel:
    noise_floor_hold: int = 50
    min_noise_floor_power: float = 1638400.0
    stationary_gate_slope: float = 10.0
    noise_gate_power: float = 27509.42
    noise_gate_slope: float = 0.3
    render_pre_window_size: int = 1
    render_post_window_size: int = 1
    model_reverb_in_nonlinear_mode: bool = True


@dataclass(frozen=True)
class ComfortNoise:
    noise_floor_dbfs: float = -96.03406


@dataclass(frozen=True)
class MaskingThresholds:
    enr_transparent: float
    enr_suppress: float
    emr_transparent: float


@dataclass(frozen=True)
class Tuning:
    mask_lf: MaskingThresholds
    mask_hf: MaskingThresholds
    max_inc_factor: float
    max_dec_factor_lf: float


@dataclass(frozen=True)
class DominantNearendDetection:
    enr_threshold: float = 0.25
    enr_exit_threshold: float = 10.0
    snr_threshold: float = 30.0
    hold_duration: int = 50
    trigger_threshold: int = 12
    use_during_initial_phase: bool = True
    use_unbounded_echo_spectrum: bool = True


@dataclass(frozen=True)
class SubbandRegion:
    low: int = 1
    high: int = 1


@dataclass(frozen=True)
class SubbandNearendDetection:
    nearend_average_blocks: int = 1
    subband1: SubbandRegion = field(default_factory=SubbandRegion)
    subband2: SubbandRegion = field(default_factory=SubbandRegion)
    nearend_threshold: float = 1.0
    snr_threshold: float = 1.0


@dataclass(frozen=True)
class HighBandsSuppression:
    enr_threshold: float = 1.0
    max_gain_during_echo: float = 1.0
    anti_howling_activation_threshold: float = 400.0
    anti_howling_gain: float = 1.0


@dataclass(frozen=True)
class HighFrequencySuppression:
    limiting_gain_band: int = 16
    bands_in_limiting_gain: int = 1


@dataclass(frozen=True)
class Suppressor:
    nearend_average_blocks: int = 4
    normal_tuning: Tuning = field(
        default_factory=lambda: Tuning(
            MaskingThresholds(0.3, 0.4, 0.3),
            MaskingThresholds(0.07, 0.1, 0.3),
            2.0,
            0.25,
        )
    )
    nearend_tuning: Tuning = field(
        default_factory=lambda: Tuning(
            MaskingThresholds(1.09, 1.1, 0.3),
            MaskingThresholds(0.1, 0.3, 0.3),
            2.0,
            0.25,
        )
    )
    lf_smoothing_during_initial_phase: bool = True
    last_permanent_lf_smoothing_band: int = 0
    last_lf_smoothing_band: int = 5
    last_lf_band: int = 5
    first_hf_band: int = 8
    dominant_nearend_detection: DominantNearendDetection = field(
        default_factory=DominantNearendDetection
    )
    subband_nearend_detection: SubbandNearendDetection = field(
        default_factory=SubbandNearendDetection
    )
    use_subband_nearend_detection: bool = False
    high_bands_suppression: HighBandsSuppression = field(
        default_factory=HighBandsSuppression
    )
    high_frequency_suppression: HighFrequencySuppression = field(
        default_factory=HighFrequencySuppression
    )
    floor_first_increase: float = 0.00001
    conservative_hf_suppression: bool = False


@dataclass(frozen=True)
class MultiChannel:
    detect_stereo_content: bool = True
    stereo_detection_threshold: float = 0.0
    stereo_detection_timeout_threshold_seconds: int = 300
    stereo_detection_hysteresis_seconds: float = 2.0


@dataclass(frozen=True)
class EchoCanceller3Config:
    buffering: Buffering = field(default_factory=Buffering)
    delay: Delay = field(default_factory=Delay)
    filter: Filter = field(default_factory=Filter)
    erle: Erle = field(default_factory=Erle)
    ep_strength: EpStrength = field(default_factory=EpStrength)
    echo_audibility: EchoAudibility = field(default_factory=EchoAudibility)
    render_levels: RenderLevels = field(default_factory=RenderLevels)
    echo_removal_control: EchoRemovalControl = field(
        default_factory=EchoRemovalControl
    )
    echo_model: EchoModel = field(default_factory=EchoModel)
    comfort_noise: ComfortNoise = field(default_factory=ComfortNoise)
    suppressor: Suppressor = field(default_factory=Suppressor)
    multi_channel: MultiChannel = field(default_factory=MultiChannel)

    def replace(self, **kwargs) -> "EchoCanceller3Config":
        return dataclasses.replace(self, **kwargs)


def create_default_multichannel_config() -> EchoCanceller3Config:
    """CreateDefaultMultichannelConfig (echo_canceller3_config.cc:288-302):
    shorter/faster coarse filter, more conservative normal-mode suppressor."""
    cfg = EchoCanceller3Config()
    return cfg.replace(
        filter=dataclasses.replace(
            cfg.filter,
            coarse=CoarseConfiguration(length_blocks=11, rate=0.95),
            coarse_initial=CoarseConfiguration(length_blocks=11, rate=0.95),
        ),
        suppressor=dataclasses.replace(
            cfg.suppressor,
            normal_tuning=Tuning(
                MaskingThresholds(0.3, 0.4, 0.3),
                MaskingThresholds(0.07, 0.1, 0.3),
                max_inc_factor=1.5,
                max_dec_factor_lf=0.35,
            ),
        ),
    )


# ---------------------------------------------------------------- validate

def _mutable(obj):
    """Nested frozen dataclass -> mutable namespace tree (for clamping)."""
    import types as _types

    if dataclasses.is_dataclass(obj):
        ns = _types.SimpleNamespace(**{
            f.name: _mutable(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
        })
        ns._dataclass_type = type(obj)
        return ns
    return obj


def _frozen(ns):
    import types as _types

    if isinstance(ns, _types.SimpleNamespace):
        t = ns._dataclass_type
        kwargs = {k: _frozen(v) for k, v in vars(ns).items()
                  if k != "_dataclass_type"}
        return t(**kwargs)
    return ns


def validate(config: EchoCanceller3Config):
    """EchoCanceller3Config::Validate (echo_canceller3_config.cc:102-283).

    Clamps every tunable into its legal range. Returns
    ``(validated_config, was_valid)`` — the reference mutates in place and
    returns the flag; frozen dataclasses return a fresh tree instead.
    """
    import math

    c = _mutable(config)
    res = [True]

    def limit(ns, name, lo, hi):
        v = getattr(ns, name)
        clamped = min(max(v, lo), hi)
        if isinstance(v, float) and not math.isfinite(clamped):
            clamped = lo
        if v != clamped:
            res[0] = False
            setattr(ns, name, type(v)(clamped))

    def floor_limit(ns, name, lo):
        v = getattr(ns, name)
        if v < lo:
            res[0] = False
            setattr(ns, name, type(v)(lo))

    if c.delay.down_sampling_factor not in (4, 8):
        c.delay.down_sampling_factor = 4
        res[0] = False

    limit(c.delay, "default_delay", 0, 5000)
    limit(c.delay, "num_filters", 0, 5000)
    limit(c.delay, "delay_headroom_samples", 0, 5000)
    limit(c.delay, "hysteresis_limit_blocks", 0, 5000)
    limit(c.delay, "fixed_capture_delay_samples", 0, 5000)
    limit(c.delay, "delay_estimate_smoothing", 0.0, 1.0)
    limit(c.delay, "delay_candidate_detection_threshold", 0.0, 1.0)
    limit(c.delay.delay_selection_thresholds, "initial", 1, 250)
    limit(c.delay.delay_selection_thresholds, "converged", 1, 250)

    floor_limit(c.filter.refined, "length_blocks", 1)
    limit(c.filter.refined, "leakage_converged", 0.0, 1000.0)
    limit(c.filter.refined, "leakage_diverged", 0.0, 1000.0)
    limit(c.filter.refined, "error_floor", 0.0, 1000.0)
    limit(c.filter.refined, "error_ceil", 0.0, 100000000.0)
    limit(c.filter.refined, "noise_gate", 0.0, 100000000.0)

    floor_limit(c.filter.refined_initial, "length_blocks", 1)
    limit(c.filter.refined_initial, "leakage_converged", 0.0, 1000.0)
    limit(c.filter.refined_initial, "leakage_diverged", 0.0, 1000.0)
    limit(c.filter.refined_initial, "error_floor", 0.0, 1000.0)
    limit(c.filter.refined_initial, "error_ceil", 0.0, 100000000.0)
    limit(c.filter.refined_initial, "noise_gate", 0.0, 100000000.0)

    if c.filter.refined.length_blocks < c.filter.refined_initial.length_blocks:
        c.filter.refined_initial.length_blocks = c.filter.refined.length_blocks
        res[0] = False

    floor_limit(c.filter.coarse, "length_blocks", 1)
    limit(c.filter.coarse, "rate", 0.0, 1.0)
    limit(c.filter.coarse, "noise_gate", 0.0, 100000000.0)

    floor_limit(c.filter.coarse_initial, "length_blocks", 1)
    limit(c.filter.coarse_initial, "rate", 0.0, 1.0)
    limit(c.filter.coarse_initial, "noise_gate", 0.0, 100000000.0)

    if c.filter.coarse.length_blocks < c.filter.coarse_initial.length_blocks:
        c.filter.coarse_initial.length_blocks = c.filter.coarse.length_blocks
        res[0] = False

    limit(c.filter, "config_change_duration_blocks", 0, 100000)
    limit(c.filter, "initial_state_seconds", 0.0, 100.0)
    limit(c.filter, "coarse_reset_hangover_blocks", 0, 250000)

    limit(c.erle, "min", 1.0, 100000.0)
    limit(c.erle, "max_l", 1.0, 100000.0)
    limit(c.erle, "max_h", 1.0, 100000.0)
    if c.erle.min > c.erle.max_l or c.erle.min > c.erle.max_h:
        c.erle.min = min(c.erle.max_l, c.erle.max_h)
        res[0] = False
    limit(c.erle, "num_sections", 1, c.filter.refined.length_blocks)

    limit(c.ep_strength, "default_gain", 0.0, 1000000.0)
    limit(c.ep_strength, "default_len", -1.0, 1.0)
    limit(c.ep_strength, "nearend_len", -1.0, 1.0)

    full_scale_power = 32768.0 * 32768.0
    limit(c.echo_audibility, "low_render_limit", 0.0, full_scale_power)
    limit(c.echo_audibility, "normal_render_limit", 0.0, full_scale_power)
    limit(c.echo_audibility, "floor_power", 0.0, full_scale_power)
    limit(c.echo_audibility, "audibility_threshold_lf", 0.0, full_scale_power)
    limit(c.echo_audibility, "audibility_threshold_mf", 0.0, full_scale_power)
    limit(c.echo_audibility, "audibility_threshold_hf", 0.0, full_scale_power)

    limit(c.render_levels, "active_render_limit", 0.0, full_scale_power)
    limit(c.render_levels, "poor_excitation_render_limit", 0.0,
          full_scale_power)
    limit(c.render_levels, "poor_excitation_render_limit_ds8", 0.0,
          full_scale_power)

    limit(c.echo_model, "noise_floor_hold", 0, 1000)
    limit(c.echo_model, "min_noise_floor_power", 0.0, 2000000.0)
    limit(c.echo_model, "stationary_gate_slope", 0.0, 1000000.0)
    limit(c.echo_model, "noise_gate_power", 0.0, 1000000.0)
    limit(c.echo_model, "noise_gate_slope", 0.0, 1000000.0)
    limit(c.echo_model, "render_pre_window_size", 0, 100)
    limit(c.echo_model, "render_post_window_size", 0, 100)

    limit(c.comfort_noise, "noise_floor_dbfs", -200.0, 0.0)

    limit(c.suppressor, "nearend_average_blocks", 1, 5000)
    for tuning in (c.suppressor.normal_tuning, c.suppressor.nearend_tuning):
        limit(tuning.mask_lf, "enr_transparent", 0.0, 100.0)
        limit(tuning.mask_lf, "enr_suppress", 0.0, 100.0)
        limit(tuning.mask_lf, "emr_transparent", 0.0, 100.0)
        limit(tuning.mask_hf, "enr_transparent", 0.0, 100.0)
        limit(tuning.mask_hf, "enr_suppress", 0.0, 100.0)
        limit(tuning.mask_hf, "emr_transparent", 0.0, 100.0)
        limit(tuning, "max_inc_factor", 0.0, 100.0)
        limit(tuning, "max_dec_factor_lf", 0.0, 100.0)

    limit(c.suppressor, "last_permanent_lf_smoothing_band", 0, 64)
    limit(c.suppressor, "last_lf_smoothing_band", 0, 64)
    limit(c.suppressor, "last_lf_band", 0, 63)
    limit(c.suppressor, "first_hf_band", c.suppressor.last_lf_band + 1, 64)

    dnd = c.suppressor.dominant_nearend_detection
    limit(dnd, "enr_threshold", 0.0, 1000000.0)
    limit(dnd, "snr_threshold", 0.0, 1000000.0)
    limit(dnd, "hold_duration", 0, 10000)
    limit(dnd, "trigger_threshold", 0, 10000)

    snd = c.suppressor.subband_nearend_detection
    limit(snd, "nearend_average_blocks", 1, 1024)
    limit(snd.subband1, "low", 0, 65)
    limit(snd.subband1, "high", snd.subband1.low, 65)
    limit(snd.subband2, "low", 0, 65)
    limit(snd.subband2, "high", snd.subband2.low, 65)
    limit(snd, "nearend_threshold", 0.0, 1.0e24)
    limit(snd, "snr_threshold", 0.0, 1.0e24)

    hbs = c.suppressor.high_bands_suppression
    limit(hbs, "enr_threshold", 0.0, 1000000.0)
    limit(hbs, "max_gain_during_echo", 0.0, 1.0)
    limit(hbs, "anti_howling_activation_threshold", 0.0, full_scale_power)
    limit(hbs, "anti_howling_gain", 0.0, 1.0)

    hfs = c.suppressor.high_frequency_suppression
    limit(hfs, "limiting_gain_band", 1, 64)
    limit(hfs, "bands_in_limiting_gain", 0, 64 - hfs.limiting_gain_band)

    limit(c.suppressor, "floor_first_increase", 0.0, 1000000.0)

    return _frozen(c), res[0]
