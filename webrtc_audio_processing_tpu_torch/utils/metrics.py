"""Host-side metrics: histogram registry + the AEC3 metrics quartet.

The port's own copy of ``webrtc_audio_processing_tpu/utils/metrics.py``,
which is pure Python (reference: system_wrappers/include/metrics.h and the
AEC3 reporters aec3/api_call_jitter_metrics.cc,
aec3/block_processor_metrics.cc, aec3/render_delay_controller_metrics.cc,
aec3/echo_remover_metrics.cc, with agc2/input_volume_stats_reporter.cc).
``api.AudioProcessing`` feeds them per-frame scalars it already fetched;
they never touch the device step. The registry keeps raw samples per
histogram name; ``get_and_reset()`` mirrors metrics::GetAndReset.
"""

from __future__ import annotations

import math
import threading
from collections import defaultdict

# -------------------------------------------------------------- registry

_LOCK = threading.Lock()
_ENABLED = False
_SAMPLES: dict[str, list[int]] = defaultdict(list)


def enable() -> None:
    """metrics::Enable(): histograms accumulate only after this call."""
    global _ENABLED
    with _LOCK:
        _ENABLED = True


def is_enabled() -> bool:
    return _ENABLED


def disable_and_clear() -> None:
    global _ENABLED
    with _LOCK:
        _ENABLED = False
        _SAMPLES.clear()


def _add(name: str, sample: int) -> None:
    if not _ENABLED:
        return
    with _LOCK:
        _SAMPLES[name].append(int(sample))


def histogram_counts_linear(name: str, sample: int, mn: int, mx: int,
                            bucket_count: int) -> None:
    """RTC_HISTOGRAM_COUNTS_LINEAR (metrics.h:106-113)."""
    del bucket_count
    _add(name, min(max(sample, mn), mx))


def histogram_enumeration(name: str, sample: int, boundary: int) -> None:
    _add(name, min(max(sample, 0), boundary - 1))


def histogram_boolean(name: str, sample: bool) -> None:
    _add(name, 1 if sample else 0)


def histogram_percentage(name: str, sample: int) -> None:
    _add(name, min(max(sample, 0), 100))


def num_events(name: str, sample: int | None = None) -> int:
    with _LOCK:
        vals = _SAMPLES.get(name, [])
        if sample is None:
            return len(vals)
        return sum(1 for v in vals if v == sample)


def get_and_reset() -> dict[str, list[int]]:
    """metrics::GetAndReset analogue: drain all recorded samples."""
    with _LOCK:
        out = {k: list(v) for k, v in _SAMPLES.items()}
        _SAMPLES.clear()
    return out


# ------------------------------------------------- ApiCallJitterMetrics

_REPORTING_INTERVAL_FRAMES = 10 * 100


class ApiCallJitterMetrics:
    """aec3/api_call_jitter_metrics.cc: min/max run lengths of
    consecutive render/capture API calls, reported every 10 s."""

    class Jitter:
        def __init__(self):
            self.reset()

        def reset(self):
            self.min = 2**31 - 1
            self.max = 0

        def update(self, run: int):
            self.min = min(self.min, run)
            self.max = max(self.max, run)

    def __init__(self):
        self.render_jitter = self.Jitter()
        self.capture_jitter = self.Jitter()
        self.reset()

    def reset(self):
        self.render_jitter.reset()
        self.capture_jitter.reset()
        self._run = 0
        self._frames_since_report = 0
        self._last_was_render = False
        self._proper_call_observed = False

    def report_render_call(self):
        if not self._last_was_render:
            if self._proper_call_observed:
                self.capture_jitter.update(self._run)
            self._run = 0
        self._run += 1
        self._last_was_render = True

    def report_capture_call(self):
        if self._last_was_render:
            if self._proper_call_observed:
                self.render_jitter.update(self._run)
            self._run = 0
            self._proper_call_observed = True
        self._run += 1
        self._last_was_render = False

        self._frames_since_report += 1
        if (self._proper_call_observed
                and self._frames_since_report == _REPORTING_INTERVAL_FRAMES):
            cap = 50  # kMaxJitterToReport
            histogram_counts_linear(
                "WebRTC.Audio.EchoCanceller.MaxRenderJitter",
                min(cap, self.render_jitter.max), 1, cap, cap)
            histogram_counts_linear(
                "WebRTC.Audio.EchoCanceller.MinRenderJitter",
                min(cap, self.render_jitter.min), 1, cap, cap)
            histogram_counts_linear(
                "WebRTC.Audio.EchoCanceller.MaxCaptureJitter",
                min(cap, self.capture_jitter.max), 1, cap, cap)
            histogram_counts_linear(
                "WebRTC.Audio.EchoCanceller.MinCaptureJitter",
                min(cap, self.capture_jitter.min), 1, cap, cap)
            self.reset()


# ------------------------------------------------ BlockProcessorMetrics

_METRICS_REPORTING_INTERVAL_BLOCKS = 10 * 250


def _category(count: int, total: int) -> int:
    """Shared None/Few/Several/Many/Constant bucketing
    (block_processor_metrics.cc:40-80)."""
    if count == 0:
        return 0
    if count > (total >> 1):
        return 4
    if count > 100:
        return 3
    if count > 10:
        return 2
    return 1


class BlockProcessorMetrics:
    """aec3/block_processor_metrics.cc: render under/overrun categories."""

    def __init__(self):
        self._capture_blocks = 0
        self._render_blocks = 0
        self._underruns = 0
        self._overruns = 0
        self.metrics_reported = False

    def update_capture(self, underrun: bool):
        self._capture_blocks += 1
        if underrun:
            self._underruns += 1
        if self._capture_blocks == _METRICS_REPORTING_INTERVAL_BLOCKS:
            self.metrics_reported = True
            histogram_enumeration(
                "WebRTC.Audio.EchoCanceller.RenderUnderruns",
                _category(self._underruns, self._capture_blocks), 5)
            histogram_enumeration(
                "WebRTC.Audio.EchoCanceller.RenderOverruns",
                _category(self._overruns, self._render_blocks or 1), 5)
            self._capture_blocks = 0
            self._render_blocks = 0
            self._underruns = 0
            self._overruns = 0

    def update_render(self, overrun: bool):
        self._render_blocks += 1
        if overrun:
            self._overruns += 1


# ----------------------------------------- RenderDelayControllerMetrics

_BLOCK_SIZE = 64


class RenderDelayControllerMetrics:
    """aec3/render_delay_controller_metrics.cc: echo-path delay, buffer
    delay, estimate reliability and change-rate, every 10 s after a 5 s
    initial settling period."""

    def __init__(self):
        self._call_counter = 0
        self._initial_update = True
        self._initial_calls = 0
        self._delay_blocks = 0
        self._reliable = 0
        self._changes = 0

    def update(self, delay_samples: int | None,
               buffer_delay_blocks: int | None, clockdrift: int):
        self._call_counter += 1
        if not self._initial_update:
            if delay_samples is not None:
                self._reliable += 1
                delay_blocks = delay_samples // _BLOCK_SIZE + 2
            else:
                delay_blocks = 0
            if delay_blocks != self._delay_blocks:
                self._changes += 1
                self._delay_blocks = delay_blocks
        else:
            self._initial_calls += 1
            if self._initial_calls == 5 * 250:
                self._initial_update = False

        if self._call_counter == _METRICS_REPORTING_INTERVAL_BLOCKS:
            histogram_counts_linear(
                "WebRTC.Audio.EchoCanceller.EchoPathDelay",
                min(124, self._delay_blocks >> 1), 0, 124, 125)
            buf = ((buffer_delay_blocks + 2) >> 1
                   if buffer_delay_blocks is not None else 0)
            histogram_counts_linear(
                "WebRTC.Audio.EchoCanceller.BufferDelay",
                min(124, buf), 0, 124, 125)
            if self._reliable == 0:
                rel = 0
            elif self._reliable > (self._call_counter >> 1):
                rel = 4
            elif self._reliable > 100:
                rel = 3
            elif self._reliable > 10:
                rel = 2
            else:
                rel = 1
            histogram_enumeration(
                "WebRTC.Audio.EchoCanceller.ReliableDelayEstimates", rel, 5)
            if self._changes == 0:
                chg = 0
            elif self._changes > 10:
                chg = 4
            elif self._changes > 5:
                chg = 3
            elif self._changes > 2:
                chg = 2
            else:
                chg = 1
            histogram_enumeration(
                "WebRTC.Audio.EchoCanceller.DelayChanges", chg, 5)
            histogram_enumeration(
                "WebRTC.Audio.EchoCanceller.Clockdrift", clockdrift, 3)
            self._call_counter = 0
            self._reliable = 0
            self._changes = 0


# ------------------------------------------------- EchoRemoverMetrics

_METRICS_COLLECTION_BLOCKS = _METRICS_REPORTING_INTERVAL_BLOCKS - 3


def transform_db_metric(negate: bool, mn: float, mx: float, offset: float,
                        scaling: float, value: float) -> int:
    """aec3::TransformDbMetricForReporting."""
    v = 10.0 * math.log10(value * scaling + 1e-10) + offset
    if negate:
        v = -v
    return int(min(max(v, mn), mx))


class EchoRemoverMetrics:
    """aec3/echo_remover_metrics.cc: ERL/ERLE value+extremes, linear-filter
    usability, capture saturation — staggered over 3 blocks every 10 s."""

    class DbMetric:
        def __init__(self, sum_value=0.0, floor_value=0.0, ceil_value=0.0):
            self.sum_value = sum_value
            self.floor_value = floor_value
            self.ceil_value = ceil_value

        def update_instant(self, value: float):
            self.sum_value = value
            self.floor_value = min(self.floor_value, value)
            self.ceil_value = max(self.ceil_value, value)

    def __init__(self):
        self._block_counter = 0
        self.metrics_reported = False
        self._reset()

    def _reset(self):
        self.erl_time_domain = self.DbMetric(0.0, 10000.0, 0.0)
        self.erle_time_domain = self.DbMetric(0.0, 0.0, 1000.0)
        self._saturated = False

    def update(self, erl_time_domain: float, erle_fullband_log2: float,
               saturated_capture: bool, usable_linear_estimate: bool,
               min_filter_delay: int):
        self.metrics_reported = False
        self._block_counter += 1
        if self._block_counter <= _METRICS_COLLECTION_BLOCKS:
            self.erl_time_domain.update_instant(erl_time_domain)
            self.erle_time_domain.update_instant(erle_fullband_log2)
            self._saturated = self._saturated or saturated_capture
        elif self._block_counter == _METRICS_COLLECTION_BLOCKS + 1:
            histogram_boolean(
                "WebRTC.Audio.EchoCanceller.UsableLinearEstimate",
                usable_linear_estimate)
            histogram_counts_linear(
                "WebRTC.Audio.EchoCanceller.FilterDelay",
                min_filter_delay, 0, 30, 31)
            histogram_boolean(
                "WebRTC.Audio.EchoCanceller.CaptureSaturation",
                self._saturated)
        elif self._block_counter == _METRICS_COLLECTION_BLOCKS + 2:
            for tag, v in (("Value", self.erl_time_domain.sum_value),
                           ("Max", self.erl_time_domain.ceil_value),
                           ("Min", self.erl_time_domain.floor_value)):
                histogram_counts_linear(
                    f"WebRTC.Audio.EchoCanceller.Erl.{tag}",
                    transform_db_metric(True, 0.0, 59.0, 30.0, 1.0, v),
                    0, 59, 30)
        else:
            for tag, v in (("Value", self.erle_time_domain.sum_value),
                           ("Max", self.erle_time_domain.ceil_value),
                           ("Min", self.erle_time_domain.floor_value)):
                histogram_counts_linear(
                    f"WebRTC.Audio.EchoCanceller.Erle.{tag}",
                    transform_db_metric(False, 0.0, 19.0, 0.0, 1.0, v),
                    0, 19, 20)
            self.metrics_reported = True
            self._block_counter = 0
            self._reset()


# ------------------------------------------- InputVolumeStatsReporter

_FRAMES_IN_60_SECONDS = 6000
_MAX_INPUT_VOLUME = 255


class InputVolumeStatsReporter:
    """agc2/input_volume_stats_reporter.{h,cc}: per-frame input-volume
    change tracking with an on-change histogram plus six rate/average
    histograms logged every 6000 frames (60 s). `kind` selects the
    "Applied"/"Recommended" metric-name prefix exactly as
    MetricNamePrefix does."""

    def __init__(self, kind: str):
        assert kind in ("Applied", "Recommended"), kind
        self._prefix = f"WebRTC.Audio.Apm.{kind}InputVolume."
        self._previous = None
        self._counter = 0
        self._num_decreases = 0
        self._sum_decreases = 0
        self._num_increases = 0
        self._sum_increases = 0

    def update_statistics(self, input_volume: int) -> None:
        """UpdateStatistics (input_volume_stats_reporter.cc:105-134)."""
        input_volume = int(input_volume)
        if self._previous is not None and input_volume != self._previous:
            histogram_counts_linear(self._prefix + "OnChange", input_volume,
                                    1, _MAX_INPUT_VOLUME, 50)
            change = input_volume - self._previous
            if change < 0:
                self._num_decreases += 1
                self._sum_decreases -= change
            else:
                self._num_increases += 1
                self._sum_increases += change
        self._counter += 1
        if self._counter >= _FRAMES_IN_60_SECONDS:
            self._log_volume_update_stats()
            self._num_decreases = self._sum_decreases = 0
            self._num_increases = self._sum_increases = 0
            self._counter = 0
        self._previous = input_volume

    def _log_volume_update_stats(self) -> None:
        """LogVolumeUpdateStats (input_volume_stats_reporter.cc:136-165)."""

        def avg(total, n):
            return int(round(total / n)) if n else 0

        histogram_counts_linear(self._prefix + "DecreaseRate",
                                self._num_decreases, 1,
                                _FRAMES_IN_60_SECONDS, 50)
        if self._num_decreases:
            histogram_counts_linear(
                self._prefix + "DecreaseAverage",
                avg(self._sum_decreases, self._num_decreases), 1,
                _MAX_INPUT_VOLUME, 50)
        histogram_counts_linear(self._prefix + "IncreaseRate",
                                self._num_increases, 1,
                                _FRAMES_IN_60_SECONDS, 50)
        if self._num_increases:
            histogram_counts_linear(
                self._prefix + "IncreaseAverage",
                avg(self._sum_increases, self._num_increases), 1,
                _MAX_INPUT_VOLUME, 50)
        num_updates = self._num_decreases + self._num_increases
        histogram_counts_linear(self._prefix + "UpdateRate", num_updates, 1,
                                _FRAMES_IN_60_SECONDS, 50)
        if num_updates:
            histogram_counts_linear(
                self._prefix + "UpdateAverage",
                avg(self._sum_decreases + self._sum_increases, num_updates),
                1, _MAX_INPUT_VOLUME, 50)


def update_histogram_on_recommended_input_volume_change_to_match_target(
        volume: int) -> None:
    """input_volume_stats_reporter.cc:167-172."""
    histogram_counts_linear(
        "WebRTC.Audio.Apm.RecommendedInputVolume.OnChangeToMatchTarget",
        int(volume), 1, _MAX_INPUT_VOLUME, 50)
