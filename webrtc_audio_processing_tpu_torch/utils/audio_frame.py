"""AudioFrame container + process proxies.

Port of ``webrtc_audio_processing_tpu/utils/audio_frame.py``, over the
port's ``api.AudioProcessing`` (any object with its
``process_stream_int16``, ``process_reverse_stream`` and
``get_statistics``), with the same error codes.

Reference: api/audio/audio_frame.h (10 ms int16 frame, <=48 kHz, mono or
interleaved multi-channel) and
modules/audio_processing/include/audio_frame_proxies.{h,cc}
(ProcessAudioFrame / ProcessReverseAudioFrame convenience wrappers).
"""

from __future__ import annotations

import numpy as np

MAX_SAMPLE_RATE = 48000
MAX_CHANNELS = 8
SAMPLES_PER_CHANNEL_10MS = MAX_SAMPLE_RATE // 100

NATIVE_RATES = (8000, 16000, 32000, 48000)

# AudioProcessing::Error subset used here (audio_processing.h:663-683).
NO_ERROR = 0
NULL_POINTER_ERROR = -1
BAD_SAMPLE_RATE_ERROR = -2
BAD_NUMBER_CHANNELS_ERROR = -5


class AudioFrame:
    """10 ms int16 frame. Data is (samples_per_channel, num_channels)
    int16; `interleaved()` exports the wire layout."""

    def __init__(self, sample_rate_hz: int = 16000, num_channels: int = 1):
        self.sample_rate_hz = 0
        self.num_channels = 0
        self.samples_per_channel = 0
        self.timestamp = 0
        self.vad_activity = None  # kVadActive/kVadPassive analog: bool
        self._data = np.zeros((0, 0), np.int16)
        self.update_frame(sample_rate_hz, num_channels)

    def update_frame(self, sample_rate_hz: int, num_channels: int,
                     data: np.ndarray | None = None):
        self.sample_rate_hz = sample_rate_hz
        self.num_channels = num_channels
        self.samples_per_channel = sample_rate_hz // 100
        if data is None:
            self.mute()
        else:
            data = np.asarray(data, np.int16)
            if data.ndim == 1:
                data = data.reshape(self.samples_per_channel, num_channels)
            self._data = data.copy()

    def mute(self):
        self._data = np.zeros(
            (self.samples_per_channel, self.num_channels), np.int16
        )

    def muted(self) -> bool:
        return not self._data.any()

    def data(self) -> np.ndarray:
        """(samples_per_channel, num_channels) int16 view."""
        return self._data

    def interleaved(self) -> np.ndarray:
        return self._data.reshape(-1)

    def set_interleaved(self, flat: np.ndarray):
        self._data = np.asarray(flat, np.int16).reshape(
            self.samples_per_channel, self.num_channels
        )


def process_audio_frame(ap, frame: AudioFrame) -> int:
    """ProcessAudioFrame (audio_frame_proxies.cc:20-45): in-place capture
    processing of an AudioFrame, with VAD activity passthrough."""
    if ap is None or frame is None:
        return NULL_POINTER_ERROR
    err, out = ap.process_stream_int16(frame.data(), frame.sample_rate_hz)
    if err == 0:
        frame._data = np.asarray(out, np.int16).reshape(
            frame.samples_per_channel, frame.num_channels
        )
        stats = ap.get_statistics()
        vd = getattr(stats, "voice_detected", None)
        if vd is not None:
            frame.vad_activity = bool(vd)
    return err


def process_reverse_audio_frame(ap, frame: AudioFrame) -> int:
    """ProcessReverseAudioFrame (audio_frame_proxies.cc:47-81)."""
    if ap is None or frame is None:
        return NULL_POINTER_ERROR
    if frame.sample_rate_hz not in NATIVE_RATES:
        return BAD_SAMPLE_RATE_ERROR
    if frame.num_channels <= 0:
        return BAD_NUMBER_CHANNELS_ERROR
    scaled = frame.data().astype(np.float32) / 32768.0  # (n, ch) in [-1,1]
    err, out = ap.process_reverse_stream(scaled, frame.sample_rate_hz)
    if err == 0 and out is not None:
        arr = np.asarray(out) * 32768.0
        frame._data = np.clip(np.round(arr), -32768, 32767).astype(
            np.int16
        ).reshape(frame.samples_per_channel, frame.num_channels)
    return err
