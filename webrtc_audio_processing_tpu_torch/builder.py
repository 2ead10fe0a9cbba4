"""The builder and the component-injection seams.

Port of ``webrtc_audio_processing_tpu/builder.py`` (reference:
api/audio/builtin_audio_processing_builder.{h,cc}, the factory that wires a
config and injected components into AudioProcessingImpl, and the injection
interfaces of api/audio/audio_processing.h:743-878, api/audio/
echo_control.h and api/audio/neural_residual_echo_estimator.h).

An injected component is a set of torch functions on batch-first tensors,
called inside the APM step at the reference's pipeline position. Its state
is a tensor, or a dataclass, dict, tuple or list of tensors, each leaf with
the batch axis first: a per-stream scalar is a (B,) tensor. ``init`` takes
the batch size and the device explicitly; everything else runs on tensors
already on that device.

The step may be captured into a CUDA graph (``step_graph``), so an injected
function must be capturable: it must not synchronise with the host (no
``.item()``, no ``bool(tensor)``, no printing of values) and must not copy
from the host to the device (no ``torch.tensor(...)`` of a Python list on
the step; build tables in ``init``). It returns new tensors or writes its
own state in place; the graph copies every returned state leaf back.

An injected function that fails raises: the APM does not carry on without
it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from webrtc_audio_processing_tpu_torch import config as cfg_mod
from webrtc_audio_processing_tpu_torch.field_trials import (
    FieldTrials,
    adjust_aec3_config,
)
from webrtc_audio_processing_tpu_torch.models.aec3 import config as aec3_config

__all__ = [
    "CustomProcessing",
    "CustomAudioAnalyzer",
    "EchoDetectorInjection",
    "NeuralResidualEchoEstimator",
    "EchoControlFactory",
    "Injections",
    "AudioProcessingBuilder",
    "BuiltinAudioProcessingBuilder",
    "aec3_echo_control_factory",
]


@dataclass(frozen=True)
class CustomProcessing:
    """An injected render pre-processor or capture post-processor
    (audio_processing.h:743-758 CustomProcessing).

    init:    (sample_rate_hz, num_channels, batch, device) -> state
    process: (state, frame (B, N, C)) -> (state, frame (B, N, C)), at the
             reference's pipeline position (render:
             audio_processing_impl.cc:1659-1661, after the copy-in; capture:
             :1483-1485, after the PostFilter and before the output RMS).
    """

    init: Callable[[int, int, int, Any], Any]
    process: Callable[[Any, Any], tuple]
    # Optional host hook for forwarded runtime settings
    # (audio_processing.h:757 SetRuntimeSetting).
    set_runtime_setting: Callable | None = None


@dataclass(frozen=True)
class CustomAudioAnalyzer:
    """An injected capture analyzer (audio_processing.h:760-765): it
    observes the full-band capture after the band merge and the echo
    detector, and changes nothing (audio_processing_impl.cc:1468-1470).

    init:    (sample_rate_hz, num_channels, batch, device) -> state
    analyze: (state, frame (B, N, C)) -> state
    """

    init: Callable[[int, int, int, Any], Any]
    analyze: Callable[[Any, Any], Any]


@dataclass(frozen=True)
class EchoDetectorInjection:
    """An injected residual echo detector (audio_processing.h:811-878, the
    EchoDetector interface and its SetEchoDetector seam). The functions
    mirror ``models/echo_detector.py``, so the built-in detector is itself
    one of these.

    init:                  (batch, device) -> state
    analyze_render_audio:  (state, render (B, N, C_ren)) -> state
    analyze_capture_audio: (state, capture (B, N, C)) -> state
    get_metrics:           state -> {name: (B,) tensor}
    """

    init: Callable[[int, Any], Any]
    analyze_render_audio: Callable[[Any, Any], Any]
    analyze_capture_audio: Callable[[Any, Any], Any]
    get_metrics: Callable[[Any], dict]


@dataclass(frozen=True)
class NeuralResidualEchoEstimator:
    """An injected neural residual echo power estimator
    (neural_residual_echo_estimator.h:26-59), called on every AEC3 block.

    estimate: (render (B, C_ren, 64), y (B, C, 64), e (B, C, 64),
               S2 (B, C, 65), Y2 (B, C, 65), E2 (B, C, 65),
               dominant_nearend (B,) bool)
              -> (R2 (B, C, 65), R2_unbounded (B, C, 65)); it takes the
              place of the residual echo estimator's model-based R2.
    get_configuration: (multi_channel: bool) -> the EchoCanceller3Config
              the estimator was trained with, or None.
    """

    estimate: Callable[..., tuple]
    get_configuration: Callable[[bool], Any] | None = None


@dataclass(frozen=True)
class EchoControlFactory:
    """An injected echo-control factory (api/audio/echo_control.h:51-60),
    used in place of the built-in AEC3 (audio_processing_impl.cc:
    1909-1984).

    create: (sample_rate_hz, num_render_channels, num_capture_channels) ->
            an object with
            ``init_state(batch, device)`` -> state,
            ``process_frame(state, render_bands (B, bands, 160, C_ren),
            capture_bands (B, bands, 160, C), parity)`` -> (state,
            capture_bands, linear output (B, 160, C) or None), with
            ``parity`` the frame's in the 2-frame block cadence (a Python
            int), and ``get_metrics(state)`` -> {name: (B,) tensor}, the
            contract ``models/aec3/echo_canceller3.py`` keeps.
    """

    create: Callable[[int, int, int], Any]


def aec3_echo_control_factory(
        aec3_cfg: aec3_config.EchoCanceller3Config | None = None,
) -> EchoControlFactory:
    """A factory whose echo control is the port's own AEC3 on ``aec3_cfg``
    (validated; the default config when None), as the APM would build it
    for a mono render: the injected path then computes what the built-in
    one does."""

    def create(sample_rate_hz, num_render_channels, num_capture_channels):
        from webrtc_audio_processing_tpu_torch.models.aec3 import (
            echo_canceller3 as ec3,
        )

        cfg, _ = aec3_config.validate(
            aec3_cfg or aec3_config.EchoCanceller3Config())
        return ec3.EchoControl(ec3.Aec3Geometry.create(
            cfg, sample_rate_hz, num_render_channels, num_capture_channels))

    return EchoControlFactory(create=create)


@dataclass(frozen=True)
class Injections:
    """Every injected component, attached to the geometry."""

    capture_post_processing: CustomProcessing | None = None
    render_pre_processing: CustomProcessing | None = None
    capture_analyzer: CustomAudioAnalyzer | None = None
    echo_detector: EchoDetectorInjection | None = None
    neural_residual_echo_estimator: NeuralResidualEchoEstimator | None = None
    echo_control_factory: EchoControlFactory | None = None

    def __bool__(self):
        return any(
            getattr(self, f.name) is not None
            for f in self.__dataclass_fields__.values()
        )


class AudioProcessingBuilder:
    """BuiltinAudioProcessingBuilder (builtin_audio_processing_builder.h:
    29-80): a fluent factory over ``api.AudioProcessing``."""

    def __init__(self, config: cfg_mod.Config | None = None):
        self._config = config or cfg_mod.Config()
        self._aec3_config = None
        self._field_trials: FieldTrials | None = None
        self._inj = {}

    # -- setters (builtin_audio_processing_builder.h:41-80) ---------------

    def set_config(self, config: cfg_mod.Config):
        self._config = config
        return self

    def set_echo_canceller3_config(self, aec3_config):
        self._aec3_config = aec3_config
        return self

    def set_field_trials(self, trials: FieldTrials | str | dict):
        if not isinstance(trials, FieldTrials):
            trials = FieldTrials(trials)
        self._field_trials = trials
        return self

    def set_echo_control_factory(self, factory: EchoControlFactory):
        self._inj["echo_control_factory"] = factory
        return self

    def set_echo_detector(self, detector: EchoDetectorInjection):
        self._inj["echo_detector"] = detector
        return self

    def set_capture_post_processing(self, processing: CustomProcessing):
        self._inj["capture_post_processing"] = processing
        return self

    def set_render_pre_processing(self, processing: CustomProcessing):
        self._inj["render_pre_processing"] = processing
        return self

    def set_capture_analyzer(self, analyzer: CustomAudioAnalyzer):
        self._inj["capture_analyzer"] = analyzer
        return self

    def set_neural_residual_echo_estimator(
        self, estimator: NeuralResidualEchoEstimator
    ):
        self._inj["neural_residual_echo_estimator"] = estimator
        return self

    # -- build (builtin_audio_processing_builder.cc:49-75) ----------------

    def build(self, device=None):
        """The ``api.AudioProcessing`` of this builder, on ``device`` (the
        card unless the caller asks for the CPU)."""
        from webrtc_audio_processing_tpu_torch import api

        aec3_cfg = self._aec3_config
        nree = self._inj.get("neural_residual_echo_estimator")
        if (nree is not None and nree.get_configuration is not None
                and aec3_cfg is None):
            multi = (self._config.pipeline.multi_channel_capture
                     or self._config.pipeline.multi_channel_render)
            aec3_cfg = nree.get_configuration(multi)
        if self._field_trials is not None and aec3_cfg is None:
            # AdjustConfig runs on the default config when none is injected
            # (echo_canceller3.cc:758-764).
            aec3_cfg = aec3_config.EchoCanceller3Config()
        if self._field_trials is not None:
            aec3_cfg = adjust_aec3_config(aec3_cfg, self._field_trials)

        injections = Injections(**self._inj) if self._inj else None
        return api.AudioProcessing(
            self._config,
            echo_canceller3_config=aec3_cfg,
            injections=injections,
            device=device,
        )


# The reference's name (builtin_audio_processing_builder.h:29).
BuiltinAudioProcessingBuilder = AudioProcessingBuilder
