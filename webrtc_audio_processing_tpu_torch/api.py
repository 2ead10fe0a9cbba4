"""Public AudioProcessing API (reference-compatible, host side).

Port of ``webrtc_audio_processing_tpu/api.py`` (reference:
api/audio/audio_processing.h, the ``AudioProcessing`` interface with its
10 ms entry points, error codes, runtime settings and statistics). The
imperative shell over ``apm.Apm``: it holds one stream as a batch of 1 on
its device, a render FIFO of the reference's render-ahead-of-capture
queue (audio_processing_impl.cc:1098-1225, bounded by
kRenderTransferQueueSizeFrames = 100), and builds the pipeline lazily from
the first capture frame's format.

Three step kinds run, eagerly, on the module of the current geometry: the
render step (``process_reverse_stream`` once the format is known), the
capture step on the render bands it queued, and the raw pair step (render
and capture in one, for render queued before the format was known). AEC3's
block ordinal and the frame's phase in the cadence (``apm.parity_period``:
2, or 6 with the hybrid AGC1) come from the state, as in ``apm.py``. The
analog level loop: ``set_stream_analog_level`` writes AGC1's level into
the state and is the applied volume of the next frames;
``recommended_stream_analog_level`` gives AGC2's input volume controller's
recommendation when it made one, else AGC1's. In mobile mode
(``EchoCanceller(mobile_mode=True)``) AECM reads the delay of
``set_stream_delay_ms`` on every capture step.
``AEC3_PAIR_KERNEL=1`` puts the subtractor on K6 as the JAX package's
switch does (``echo_canceller3.pair_kernel_from_env``).

Usage::

    ap = AudioProcessing(config)             # on the card; device="cpu"
    err, render_out = ap.process_reverse_stream(far)     # (480, C) float
    err, out = ap.process_stream(near, 48000)            # (480, C) float
    stats = ap.get_statistics()
"""

from __future__ import annotations

import dataclasses
import os
from collections import deque

import numpy as np
import torch

from webrtc_audio_processing_tpu_torch import apm
from webrtc_audio_processing_tpu_torch import config as cfg_mod
from webrtc_audio_processing_tpu_torch.models import rms_level
from webrtc_audio_processing_tpu_torch.models.agc1 import gain_control
from webrtc_audio_processing_tpu_torch.models.aec3 import (
    echo_canceller3 as ec3,
)
from webrtc_audio_processing_tpu_torch.utils import metrics

# Error codes (audio_processing.h:663-683).
kNoError = 0
kUnspecifiedError = -1
kCreationFailedError = -2
kUnsupportedComponentError = -3
kUnsupportedFunctionError = -4
kNullPointerError = -5
kBadParameterError = -6
kBadSampleRateError = -7
kBadDataLengthError = -8
kBadNumberChannelsError = -9
kFileError = -10
kStreamParameterNotSetError = -11
kNotEnabledError = -12
kBadStreamParameterWarning = -13

RENDER_QUEUE_SIZE_FRAMES = 100  # aec3_common.h:41

frame_size = cfg_mod.frame_size


class RuntimeSetting:
    """AudioProcessing::RuntimeSetting (audio_processing.h:380-470): a
    typed value with the reference's factory constructors."""

    NOT_SPECIFIED = 0
    CAPTURE_PRE_GAIN = 1
    CAPTURE_COMPRESSION_GAIN = 2
    CAPTURE_FIXED_POST_GAIN = 3
    PLAYOUT_VOLUME_CHANGE = 4
    CUSTOM_RENDER_SETTING = 5
    PLAYOUT_AUDIO_DEVICE_CHANGE = 6
    CAPTURE_POST_GAIN = 7
    CAPTURE_OUTPUT_USED = 8

    def __init__(self, type_=NOT_SPECIFIED, value=0.0):
        self.type = type_
        self.value = value

    @classmethod
    def create_capture_pre_gain(cls, gain: float):
        return cls(cls.CAPTURE_PRE_GAIN, float(gain))

    @classmethod
    def create_capture_post_gain(cls, gain: float):
        return cls(cls.CAPTURE_POST_GAIN, float(gain))

    @classmethod
    def create_compression_gain_db(cls, gain_db: int):
        return cls(cls.CAPTURE_COMPRESSION_GAIN, float(gain_db))

    @classmethod
    def create_capture_fixed_post_gain(cls, gain_db: float):
        return cls(cls.CAPTURE_FIXED_POST_GAIN, float(gain_db))

    @classmethod
    def create_playout_volume_change(cls, volume: int):
        return cls(cls.PLAYOUT_VOLUME_CHANGE, int(volume))

    @classmethod
    def create_playout_audio_device_change(cls, device_info):
        return cls(cls.PLAYOUT_AUDIO_DEVICE_CHANGE, device_info)

    @classmethod
    def create_custom_render_setting(cls, payload: int):
        return cls(cls.CUSTOM_RENDER_SETTING, int(payload))

    @classmethod
    def create_capture_output_used_setting(cls, used: bool):
        return cls(cls.CAPTURE_OUTPUT_USED, bool(used))


class AudioProcessingStats:
    """audio_processing_statistics.h:25-66."""

    def __init__(self):
        self.output_rms_dbfs = None
        self.voice_detected = None
        self.echo_return_loss = None
        self.echo_return_loss_enhancement = None
        self.divergent_filter_fraction = None
        self.delay_median_ms = None
        self.delay_standard_deviation_ms = None
        self.residual_echo_likelihood = None
        self.residual_echo_likelihood_recent_max = None
        self.delay_ms = None


def _structure(node, path="state"):
    """The shape of a state: each tensor leaf's path, shape and dtype, and
    which fields are None (the frame counter, a plain int, left out)."""
    if node is None:
        return ((path, None),)
    if isinstance(node, int):
        return ()
    if dataclasses.is_dataclass(node):
        return sum((_structure(getattr(node, f.name), f"{path}.{f.name}")
                    for f in dataclasses.fields(node)), ())
    return ((path, tuple(node.shape), node.dtype),)


def _item(stats, key):
    """Stream 0's value of a stats entry, read to the host."""
    return stats[key][0].item()


class AudioProcessing:
    """The reference's imperative APM around the port's step, one stream.

    Configure, then push 10 ms frames through ``process_reverse_stream``
    and ``process_stream``. The state lives on ``device``: the card unless
    the caller asks for the CPU; with no card and no ``device`` it raises.
    """

    def __init__(self, config: cfg_mod.Config | None = None,
                 echo_canceller3_config=None, injections=None, device=None):
        if injections is not None:
            raise NotImplementedError(
                "builder injections are not ported yet (ROADMAP Queue 1 "
                "item 12)")
        self._device = apm._resolve_device(device)
        self._config = config or cfg_mod.Config()
        self._aec3_config = echo_canceller3_config
        self._geo = None
        self._geo_key = None
        self._module = None
        self._state = None
        self._render_queue = deque()
        self._stream_delay_ms = 0
        self._stream_delay_set = False
        self._key_pressed = False
        self._analog_level = None
        self._playout_volume = None
        self._last_stats = {}
        # Mute and unmute (kCaptureOutputUsed,
        # audio_processing_impl.cc:818-839, applied :1540-1552).
        self._capture_output_used = True
        self._capture_output_used_last_frame = True
        # The stereo-content detector's verdict, tracked on the host: the
        # AEC3 geometry is rebuilt when it flips (echo_canceller3.cc:977-1005).
        self._aec3_stereo_active = False
        # Host-side AEC3 metric reporters (utils/metrics.py).
        self._jitter_metrics = metrics.ApiCallJitterMetrics()
        self._block_metrics = metrics.BlockProcessorMetrics()
        self._delay_metrics = metrics.RenderDelayControllerMetrics()
        self._remover_metrics = metrics.EchoRemoverMetrics()
        # Input-volume histograms (agc2/input_volume_stats_reporter.cc,
        # wired as audio_processing_impl.cc:1313-1316 and :1518-1524).
        self._applied_volume_stats = metrics.InputVolumeStatsReporter(
            "Applied")
        self._recommended_volume_stats = metrics.InputVolumeStatsReporter(
            "Recommended")

    @property
    def device(self) -> torch.device:
        return self._device

    # ---------------------------------------------------- debug recording

    def attach_aec_dump(self, path: str):
        """AttachAecDump (audio_processing.h:627-640)."""
        raise NotImplementedError(
            "the AEC dump recorder is not ported yet (ROADMAP Queue 1 item "
            "12)")

    def detach_aec_dump(self):
        """DetachAecDump: nothing is ever attached."""
        return kNoError

    def attach_data_dumper(self, directory: str):
        """ApmDataDumper analog: AEC3's debug taps."""
        raise NotImplementedError(
            "AEC3 debug taps are not ported yet (ROADMAP Queue 1 item 11)")

    def detach_data_dumper(self):
        return kNoError

    # ------------------------------------------------------------ config

    def apply_config(self, config: cfg_mod.Config):
        """ApplyConfig (audio_processing_impl.cc:694-771): an identical
        config keeps every state; a changed one re-initializes at the next
        frame."""
        if config == self._config:
            return
        self._config = config
        self._geo = None

    def initialize(self):
        """Initialize() (audio_processing.h:489-499): reset the state, keep
        the config."""
        self._geo = None

    def _ensure_initialized(self, capture_rate, capture_channels,
                            render_rate, render_channels,
                            capture_out_rate=None):
        geo_key = (capture_rate, capture_channels, render_rate,
                   render_channels, capture_out_rate)
        if self._geo is not None and self._geo_key == geo_key:
            return
        ring_dtype = os.environ.get("APM_AEC3_RING_DTYPE", "float32")
        if ring_dtype != "float32":
            raise NotImplementedError(
                f"APM_AEC3_RING_DTYPE={ring_dtype}: the AEC3 render rings "
                f"run in float32 only (ROADMAP Queue 1 item 10d)")
        self._geo_key = geo_key
        # A format-driven (re)initialization recreates the render transfer
        # queues (InitializeLocked -> AllocateRenderQueue,
        # audio_processing_impl.cc:615, :1148-1199): render queued before
        # it is dropped.
        self._render_queue.clear()
        self._geo = apm.ApmGeometry.create(
            self._config,
            capture_input_rate=capture_rate,
            num_capture_channels=capture_channels,
            capture_output_rate=capture_out_rate or capture_rate,
            render_input_rate=render_rate or capture_rate,
            num_render_channels=render_channels or 1,
            aec3_cfg=self._aec3_config,
            aec3_stereo_content=self._aec3_stereo_active,
            aec3_pair_kernel=ec3.pair_kernel_from_env(),
        )
        self._module = apm.module_for(self._geo, self._device)
        self._state = apm.init_state(self._geo, 1, self._device)
        # A level set before the (lazy, format-driven) initialization
        # survives it: GainControlImpl keeps analog_capture_level_ across
        # Initialize (gain_control_impl.cc:265-275, :349).
        self._write_agc1_level()

    # ------------------------------------------------------------ streams

    def _tensor(self, frame: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(frame)[None].to(self._device)

    def process_reverse_stream(self, render: np.ndarray,
                               sample_rate_hz: int | None = None):
        """ProcessReverseStream (audio_processing.h:562-569).

        render: (frames, channels) float in [-1, 1]. Returns (err, render
        out). Once the format is known and matches, the render half runs
        here and its bands are queued for the next capture frame (the
        SwapQueue hand-off); before that the raw frame is queued and runs
        inside the next capture step. A full queue drops its oldest frame.
        """
        render = np.ascontiguousarray(render, np.float32)
        if render.ndim == 1:
            render = render[:, None]
        if render.shape[1] == 0:
            return kBadNumberChannelsError, render
        if len(self._render_queue) >= RENDER_QUEUE_SIZE_FRAMES:
            self._render_queue.popleft()
            self._block_metrics.update_render(overrun=True)
        if self._config.echo_canceller.enabled:
            self._jitter_metrics.report_render_call()

        geo = self._geo
        if (geo is not None
                and render.shape[0] == frame_size(geo.render_input_rate)
                and render.shape[1] == geo.num_render_channels):
            self._state, render_out, render_bands = (
                self._module.process_render_stream(self._state,
                                                   self._tensor(render)))
            self._render_queue.append(("bands", render_bands))
            return kNoError, render_out[0].cpu().numpy()
        self._render_queue.append(("raw", render))
        return kNoError, render

    def analyze_reverse_stream(self, render, sample_rate_hz=None):
        """AnalyzeReverseStream (audio_processing.h:577)."""
        err, _ = self.process_reverse_stream(render, sample_rate_hz)
        return err

    def process_stream(self, capture: np.ndarray, sample_rate_hz: int,
                       output_sample_rate_hz: int | None = None):
        """ProcessStream, float (audio_processing.h:554).

        capture: (frames, channels) float in [-1, 1]. Returns (err,
        output (frames, channels) float32)."""
        capture = np.ascontiguousarray(capture, np.float32)
        if capture.ndim == 1:
            capture = capture[:, None]
        if capture.shape[1] == 0:
            # HandleUnsupportedAudioFormats (audio_processing_impl.cc:
            # 248-347): a zero channel count is rejected.
            return kBadNumberChannelsError, capture
        if capture.shape[0] != frame_size(sample_rate_hz):
            return kBadDataLengthError, capture
        if sample_rate_hz % 100 != 0:
            return kBadSampleRateError, capture

        render_bands = render = None
        render_is_real = False
        if self._render_queue:
            kind, payload = self._render_queue.popleft()
            if kind == "bands":
                render_bands = payload
                render_rate = self._geo.render_input_rate
                render_channels = self._geo.num_render_channels
            else:
                render, render_is_real = payload, True
                render_rate = render.shape[0] * 100
                render_channels = render.shape[1]
        else:
            render_rate = sample_rate_hz
            render_channels = self._geo.num_render_channels if self._geo else 1

        geo_before = self._geo
        self._ensure_initialized(sample_rate_hz, capture.shape[1],
                                 render_rate, render_channels,
                                 output_sample_rate_hz)
        if self._geo is not geo_before:
            # The re-init dropped whatever render was queued: it belongs
            # to the old format.
            render_bands, render_is_real = None, False
        if render_bands is None and not render_is_real:
            render = np.zeros((frame_size(self._geo.render_input_rate),
                               self._geo.num_render_channels), np.float32)

        volume = 0 if self._analog_level is None else self._analog_level
        cap = self._tensor(capture)
        if render_bands is not None:
            self._state, out, _, stats = self._module(
                self._state, cap, render_bands=render_bands,
                stream_delay_ms=self._stream_delay_ms,
                applied_input_volume=volume)
        else:
            self._state, out, _, stats = self._module(
                self._state, cap, self._tensor(render),
                render_valid=render_is_real,
                stream_delay_ms=self._stream_delay_ms,
                applied_input_volume=volume)
        self._last_stats = stats
        # Input-volume histograms: the applied volume when one was set for
        # this frame (audio_processing_impl.cc:1313-1316), the recommended
        # one after the pipeline ran (:1518-1524).
        if self._analog_level is not None:
            self._applied_volume_stats.update_statistics(self._analog_level)
            self._recommended_volume_stats.update_statistics(
                self.recommended_stream_analog_level())
        # Stereo-content flip (echo_canceller3.cc:977-1005): rebuild AEC3
        # with the config and channel count ConfigSelector now picks.
        if (self._geo.aec3_dynamic_stereo
                and _item(stats, "multichannel_config_changed")):
            self._handle_stereo_content_flip(
                bool(_item(stats, "multichannel_content_detected")))
        out_np = out[0].cpu().numpy()
        # Unmute click suppression (audio_processing_impl.cc:1540-1552):
        # the first frame after the output is used again is zeroed.
        if (self._capture_output_used
                and not self._capture_output_used_last_frame):
            out_np = np.zeros_like(out_np)
        self._capture_output_used_last_frame = self._capture_output_used
        if self._config.echo_canceller.enabled:
            self._feed_aec3_metrics(stats)
        return kNoError, out_np

    def process_stream_int16(self, capture: np.ndarray, sample_rate_hz: int):
        """ProcessStream, int16 (audio_processing.h:542)."""
        x = np.asarray(capture, np.int16).astype(np.float32) / 32768.0
        err, out = self.process_stream(x, sample_rate_hz)
        out16 = np.clip(out * 32768.0, -32768, 32767)
        out16 = np.trunc(out16 + np.copysign(0.5, out16)).astype(np.int16)
        return err, out16

    # ------------------------------------------------------------ params

    def get_linear_aec_output(self):
        """GetLinearAecOutput (audio_processing.h:584): the most recent
        frame's linear AEC error at 16 kHz, (channels, 160), or None
        without AEC3."""
        out = self._last_stats.get("linear_aec_output")
        if out is None:
            return None
        return out[0].T.cpu().numpy()

    def set_stream_delay_ms(self, delay_ms: int) -> int:
        """set_stream_delay_ms (audio_processing.h:611): clamped to
        [0, 500] with a warning."""
        self._stream_delay_set = True
        if delay_ms < 0:
            self._stream_delay_ms = 0
            return kBadStreamParameterWarning
        if delay_ms > 500:
            self._stream_delay_ms = 500
            return kBadStreamParameterWarning
        self._stream_delay_ms = delay_ms
        return kNoError

    def stream_delay_ms(self) -> int:
        return self._stream_delay_ms

    def set_stream_key_pressed(self, key_pressed: bool):
        self._key_pressed = key_pressed

    def set_runtime_setting(self, setting: RuntimeSetting) -> bool:
        """SetRuntimeSetting (audio_processing.h:506-515) with the capture
        handlers of audio_processing_impl.cc:963-1064. A gain setting
        changes the active config and keeps the stream's state."""
        c = self._config
        t, v = setting.type, setting.value
        if t == RuntimeSetting.CAPTURE_PRE_GAIN:
            if c.pre_amplifier.enabled:
                c = c.replace(pre_amplifier=dataclasses.replace(
                    c.pre_amplifier, fixed_gain_factor=float(v)))
            elif c.capture_level_adjustment.enabled:
                c = c.replace(capture_level_adjustment=dataclasses.replace(
                    c.capture_level_adjustment, pre_gain_factor=float(v)))
            else:
                return True  # ignored, as in the reference
            self._refresh_config(c)
        elif t == RuntimeSetting.CAPTURE_POST_GAIN:
            if c.capture_level_adjustment.enabled:
                c = c.replace(capture_level_adjustment=dataclasses.replace(
                    c.capture_level_adjustment, post_gain_factor=float(v)))
                self._refresh_config(c)
        elif t == RuntimeSetting.CAPTURE_COMPRESSION_GAIN:
            # AGC1's compression gain, ignored when an input volume
            # controller owns the mic (audio_processing_impl.cc:1010-1013):
            # AGC2's, or the hybrid AGC's manager, which sets it itself.
            ivc = (c.gain_controller2.enabled
                   and c.gain_controller2.input_volume_controller.enabled)
            hybrid = (c.gain_controller1.enabled
                      and c.gain_controller1.analog_gain_controller.enabled)
            if not ivc and not hybrid and c.gain_controller1.enabled:
                c = c.replace(gain_controller1=dataclasses.replace(
                    c.gain_controller1, compression_gain_db=int(v + 0.5)))
                self._refresh_config(c)
        elif t == RuntimeSetting.CAPTURE_FIXED_POST_GAIN:
            if c.gain_controller2.enabled:
                c = c.replace(gain_controller2=dataclasses.replace(
                    c.gain_controller2,
                    fixed_digital=dataclasses.replace(
                        c.gain_controller2.fixed_digital,
                        gain_db=float(v))))
                self._refresh_config(c)
        elif t == RuntimeSetting.PLAYOUT_VOLUME_CHANGE:
            self._playout_volume = int(v)
        elif t in (RuntimeSetting.PLAYOUT_AUDIO_DEVICE_CHANGE,
                   RuntimeSetting.CUSTOM_RENDER_SETTING):
            # Forwarded to an injected render pre-processor only
            # (HandleRenderRuntimeSettings, audio_processing_impl.cc:
            # 1072-1096); the port takes no injections.
            pass
        elif t == RuntimeSetting.CAPTURE_OUTPUT_USED:
            self._capture_output_used = bool(v)
        return True

    def _feed_aec3_metrics(self, stats):
        """Feed the host-side AEC3 reporters once per block of the frame
        (2 or 3). Reading the stats syncs with the device, so it happens
        only while histograms are collected (metrics::Enable())."""
        if "aec3_erl_time_domain" not in stats:
            return
        self._jitter_metrics.report_capture_call()
        if not metrics.is_enabled():
            return
        n_blocks = 2 if self._state.frame_counter % 2 == 1 else 3
        delay_ms = int(_item(stats, "delay_ms"))
        valid = bool(_item(stats, "aec3_external_delay_valid"))
        for _ in range(n_blocks):
            self._block_metrics.update_capture(underrun=False)
            self._delay_metrics.update(
                delay_ms * 16 if valid else None,
                delay_ms // 4 if valid else None,
                int(_item(stats, "aec3_clockdrift_level")))
            self._remover_metrics.update(
                float(_item(stats, "aec3_erl_time_domain")),
                float(_item(stats, "aec3_erle_fullband_log2")),
                bool(_item(stats, "aec3_saturated_capture")),
                bool(_item(stats, "aec3_usable_linear_estimate")),
                int(_item(stats, "aec3_min_filter_delay")))

    def _handle_stereo_content_flip(self, stereo_active: bool):
        """Rebuild AEC3 under the newly selected config and channel count;
        the content detector and every other module keep their state
        (EchoCanceller3::Initialize, echo_canceller3.cc:827-850, 977-981).
        The new canceller starts at block 0 on an even frame."""
        self._aec3_stereo_active = stereo_active
        old = self._state
        self._geo = None
        self._ensure_initialized(*self._geo_key)
        if self._geo.aec3 is None:
            return
        fresh = ec3.init_state(self._geo.aec3, 1, self._device)
        fresh = fresh.replace(mc_detector=old.aec.mc_detector)
        self._state = dataclasses.replace(
            old, aec=fresh,
            aec3_block_ordinal=torch.zeros_like(old.aec3_block_ordinal),
            frame_counter=0)

    def _refresh_config(self, new_config):
        """Swap the active config and its module; the stream's state stays
        when its structure is unchanged, with the capture levels adjuster's
        configured gains taken from the new config (SetPreGain,
        SetPostGain: audio_processing_impl.cc:976-1005)."""
        self._config = new_config
        if self._geo is None:
            return
        old = self._state
        self._geo = None
        self._ensure_initialized(*self._geo_key)
        if _structure(old) != _structure(self._state):
            return
        if old.cla is not None:
            cla_cfg = new_config.capture_level_adjustment
            old = dataclasses.replace(old, cla=old.cla.replace(
                pre_gain=torch.full_like(old.cla.pre_gain,
                                         cla_cfg.pre_gain_factor),
                post_gain=torch.full_like(old.cla.post_gain,
                                          cla_cfg.post_gain_factor)))
        self._state = old

    def _write_agc1_level(self):
        if (self._analog_level is not None and self._state is not None
                and self._state.agc1 is not None):
            self._state = dataclasses.replace(
                self._state, agc1=gain_control.set_stream_analog_level(
                    self._state.agc1, self._analog_level))

    def set_stream_analog_level(self, level: int):
        """set_stream_analog_level (audio_processing.h:590-596): the
        applied mic volume, clamped to [0, 255], that AGC2's input volume
        controller and the hybrid AGC1 read, and AGC1's analog level
        (GainControlImpl::set_stream_analog_level); it survives the lazy
        initialization."""
        self._analog_level = int(np.clip(level, 0, 255))
        self._write_agc1_level()

    def recommended_stream_analog_level(self) -> int:
        """recommended_stream_analog_level (audio_processing.h:599-607):
        AGC2's input volume controller's recommendation when it made one,
        else AGC1's recommended level, else the level last set (255 when
        none was)."""
        st = self._last_stats
        if ("agc2_recommended_input_volume" in st
                and _item(st, "agc2_recommended_input_volume_valid")):
            return int(_item(st, "agc2_recommended_input_volume"))
        if "agc1_recommended_level" in st:
            return int(_item(st, "agc1_recommended_level"))
        return 255 if self._analog_level is None else self._analog_level

    def proc_sample_rate_hz(self) -> int:
        return self._geo.capture_processing_rate if self._geo else 0

    def num_bands(self) -> int:
        return self._geo.capture_processing_rate // 16000 if self._geo else 0

    # ------------------------------------------------------------ stats

    def get_statistics(self) -> AudioProcessingStats:
        """GetStatistics (audio_processing.h:652)."""
        s = AudioProcessingStats()
        st = self._last_stats
        if not st:
            return s
        if "echo_return_loss" in st:
            s.echo_return_loss = float(_item(st, "echo_return_loss"))
            s.echo_return_loss_enhancement = float(
                _item(st, "echo_return_loss_enhancement"))
            s.delay_ms = int(_item(st, "delay_ms"))
        if "aec3_divergent_filter_fraction" in st:
            # Filled here; the reference declares the field and leaves it
            # to other backends (audio_processing_statistics.h:45).
            s.divergent_filter_fraction = float(
                _item(st, "aec3_divergent_filter_fraction"))
        if self._state.delay_history_ms is not None:
            hist = self._state.delay_history_ms[0].cpu().numpy()
            valid = self._state.delay_history_valid[0].cpu().numpy()
            if valid.any():
                d = hist[valid]
                s.delay_median_ms = int(np.median(d))
                s.delay_standard_deviation_ms = int(np.std(d))
        s.output_rms_dbfs = int(rms_level.average(self._state.output_rms)[0])
        if "echo_likelihood" in st:
            s.residual_echo_likelihood = float(_item(st, "echo_likelihood"))
            s.residual_echo_likelihood_recent_max = float(
                _item(st, "echo_likelihood_recent_max"))
        if "agc2_speech_probability" in st:
            s.voice_detected = bool(
                _item(st, "agc2_speech_probability") > 0.5)
        return s
