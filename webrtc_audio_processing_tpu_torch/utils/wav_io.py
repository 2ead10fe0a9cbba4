"""WAV and raw PCM I/O (host side, numpy and ``wave`` only).

The port's own copy of ``webrtc_audio_processing_tpu/utils/wav_io.py``
(reference: common_audio/wav_file.h:38-76). Arrays are (frames, channels)
float32 in [-1, 1], time leading.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import wave


def read_wav(path) -> tuple[np.ndarray, int]:
    """Read a WAV file -> ((frames, channels) float32 in [-1, 1], rate)."""
    with wave.open(str(path), "rb") as w:
        n_ch = w.getnchannels()
        rate = w.getframerate()
        width = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<f4").astype(np.float32)
    else:
        raise ValueError(f"unsupported sample width {width}")
    return data.reshape(-1, n_ch).copy(), rate


def write_wav(path, data: np.ndarray, sample_rate: int) -> None:
    """Write (frames, channels) float32 [-1, 1] data as 16-bit PCM WAV."""
    data = np.asarray(data, np.float32)
    if data.ndim == 1:
        data = data[:, None]
    samples = np.clip(data * 32768.0, -32768, 32767)
    samples = np.trunc(samples + np.copysign(0.5, samples)).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(data.shape[1])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(samples.tobytes())


def read_pcm16(path, num_channels: int = 1) -> np.ndarray:
    """Read a headerless 16-bit little-endian PCM file (interleaved) into
    (frames, channels) float32 in [-1, 1] — format of the reference's
    tests/resources/*.pcm vectors."""
    raw = Path(path).read_bytes()
    data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    frames = len(data) // num_channels
    return data[: frames * num_channels].reshape(frames, num_channels).copy()


def write_pcm16(path, data: np.ndarray) -> None:
    """Write (frames, channels) float32 [-1, 1] as interleaved 16-bit PCM."""
    data = np.asarray(data, np.float32)
    if data.ndim == 1:
        data = data[:, None]
    samples = np.clip(data * 32768.0, -32768, 32767)
    samples = np.trunc(samples + np.copysign(0.5, samples)).astype("<i2")
    Path(path).write_bytes(samples.tobytes())
