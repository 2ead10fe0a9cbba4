"""Static configuration tree mirroring ``AudioProcessing::Config``.

Port of ``webrtc_audio_processing_tpu/config.py`` with the same classes,
fields and defaults (reference: webrtc/api/audio/audio_processing.h:137-376).
It is plain Python: importing the JAX package's copy would import jax. The
config is resolved when the pipeline is built and selects which submodules
run; all classes are frozen dataclasses, hashable and usable as cache keys.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field


class DownmixMethod(enum.Enum):
    """How multi-channel capture audio is downmixed to mono.

    Reference: audio_processing.h:141-145 (Pipeline::DownmixMethod).
    """

    AVERAGE_CHANNELS = "average"
    USE_FIRST_CHANNEL = "first"


class NoiseSuppressionLevel(enum.Enum):
    """Reference: audio_processing.h:208 (NoiseSuppression::Level)."""

    LOW = "low"
    MODERATE = "moderate"
    HIGH = "high"
    VERY_HIGH = "very_high"


class Agc1Mode(enum.Enum):
    """Reference: audio_processing.h:233-258 (GainController1::Mode)."""

    ADAPTIVE_ANALOG = "adaptive_analog"
    ADAPTIVE_DIGITAL = "adaptive_digital"
    FIXED_DIGITAL = "fixed_digital"


class ClippingPredictorMode(enum.Enum):
    """Reference: audio_processing.h:296-303."""

    CLIPPING_EVENT_PREDICTION = "event"
    ADAPTIVE_STEP_CLIPPING_PEAK_PREDICTION = "adaptive_step"
    FIXED_STEP_CLIPPING_PEAK_PREDICTION = "fixed_step"


@dataclass(frozen=True)
class Pipeline:
    """Reference: audio_processing.h:139-157."""

    maximum_internal_processing_rate: int = 32000
    multi_channel_render: bool = False
    multi_channel_capture: bool = False
    capture_downmix_method: DownmixMethod = DownmixMethod.AVERAGE_CHANNELS

    def __post_init__(self) -> None:
        # Values other than 32000 are treated as 48000 (audio_processing.h:147).
        if self.maximum_internal_processing_rate != 32000:
            object.__setattr__(self, "maximum_internal_processing_rate", 48000)


@dataclass(frozen=True)
class PreAmplifier:
    """Reference: audio_processing.h:161-167."""

    enabled: bool = False
    fixed_gain_factor: float = 1.0


@dataclass(frozen=True)
class AnalogMicGainEmulation:
    """Reference: audio_processing.h:181-191."""

    enabled: bool = False
    initial_level: int = 255


@dataclass(frozen=True)
class CaptureLevelAdjustment:
    """Reference: audio_processing.h:169-192."""

    enabled: bool = False
    pre_gain_factor: float = 1.0
    post_gain_factor: float = 1.0
    analog_mic_gain_emulation: AnalogMicGainEmulation = field(
        default_factory=AnalogMicGainEmulation
    )


@dataclass(frozen=True)
class HighPassFilter:
    """Reference: audio_processing.h:194-197."""

    enabled: bool = False
    apply_in_full_band: bool = True


@dataclass(frozen=True)
class EchoCanceller:
    """Reference: audio_processing.h:199-206."""

    enabled: bool = False
    mobile_mode: bool = False
    export_linear_aec_output: bool = False
    enforce_high_pass_filtering: bool = True


@dataclass(frozen=True)
class NoiseSuppression:
    """Reference: audio_processing.h:208-214."""

    enabled: bool = False
    level: NoiseSuppressionLevel = NoiseSuppressionLevel.MODERATE
    analyze_linear_aec_output_when_available: bool = False


@dataclass(frozen=True)
class TransientSuppression:
    """Deprecated in the reference (audio_processing.h:216-220)."""

    enabled: bool = False


@dataclass(frozen=True)
class ClippingPredictor:
    """Reference: audio_processing.h:294-319."""

    enabled: bool = False
    mode: ClippingPredictorMode = ClippingPredictorMode.CLIPPING_EVENT_PREDICTION
    window_length: int = 5
    reference_window_length: int = 5
    reference_window_delay: int = 5
    clipping_threshold: float = -1.0
    crest_factor_margin: float = 3.0
    use_predicted_step: bool = True


@dataclass(frozen=True)
class AnalogGainController:
    """Reference: audio_processing.h:276-321."""

    enabled: bool = True
    startup_min_volume: int = 0
    clipped_level_min: int = 70
    enable_digital_adaptive: bool = True
    clipped_level_step: int = 15
    clipped_ratio_threshold: float = 0.1
    clipped_wait_frames: int = 300
    clipping_predictor: ClippingPredictor = field(default_factory=ClippingPredictor)


@dataclass(frozen=True)
class GainController1:
    """AGC1. Reference: audio_processing.h:222-322."""

    enabled: bool = False
    mode: Agc1Mode = Agc1Mode.ADAPTIVE_ANALOG
    target_level_dbfs: int = 3
    compression_gain_db: int = 9
    enable_limiter: bool = True
    analog_gain_controller: AnalogGainController = field(
        default_factory=AnalogGainController
    )


@dataclass(frozen=True)
class InputVolumeController:
    """Reference: audio_processing.h:340-347."""

    enabled: bool = False


@dataclass(frozen=True)
class AdaptiveDigital:
    """Reference: audio_processing.h:349-364."""

    enabled: bool = False
    headroom_db: float = 5.0
    max_gain_db: float = 50.0
    initial_gain_db: float = 15.0
    max_gain_change_db_per_second: float = 6.0
    max_output_noise_level_dbfs: float = -50.0


@dataclass(frozen=True)
class FixedDigital:
    """Reference: audio_processing.h:366-371."""

    gain_db: float = 0.0


@dataclass(frozen=True)
class GainController2:
    """AGC2. Reference: audio_processing.h:324-373."""

    enabled: bool = False
    input_volume_controller: InputVolumeController = field(
        default_factory=InputVolumeController
    )
    adaptive_digital: AdaptiveDigital = field(default_factory=AdaptiveDigital)
    fixed_digital: FixedDigital = field(default_factory=FixedDigital)


@dataclass(frozen=True)
class Config:
    """Top-level APM configuration. Reference: audio_processing.h:137-376."""

    pipeline: Pipeline = field(default_factory=Pipeline)
    pre_amplifier: PreAmplifier = field(default_factory=PreAmplifier)
    capture_level_adjustment: CaptureLevelAdjustment = field(
        default_factory=CaptureLevelAdjustment
    )
    high_pass_filter: HighPassFilter = field(default_factory=HighPassFilter)
    echo_canceller: EchoCanceller = field(default_factory=EchoCanceller)
    noise_suppression: NoiseSuppression = field(default_factory=NoiseSuppression)
    transient_suppression: TransientSuppression = field(
        default_factory=TransientSuppression
    )
    gain_controller1: GainController1 = field(default_factory=GainController1)
    gain_controller2: GainController2 = field(default_factory=GainController2)

    def replace(self, **kwargs) -> "Config":
        return dataclasses.replace(self, **kwargs)



# Native API sample rates (audio_processing.h:686-691) and frame geometry
# (audio_processing.h:697-719: one frame is 10 ms, rate/100 samples/channel).
NATIVE_SAMPLE_RATES_HZ = (8000, 16000, 32000, 48000)
MAX_NATIVE_SAMPLE_RATE_HZ = 48000


def frame_size(sample_rate_hz: int) -> int:
    """Samples per channel in one 10 ms frame (audio_processing.h:712-719)."""
    return sample_rate_hz // 100
