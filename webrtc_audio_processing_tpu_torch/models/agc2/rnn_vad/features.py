"""RNN-VAD 42-dim feature extraction.

Port of ``webrtc_audio_processing_tpu/models/agc2/rnn_vad/features.py``
(reference: agc2/rnn_vad/features_extraction.cc, lp_residual.cc,
spectral_features.cc, spectral_features_internal.cc). Feature layout
(features_extraction.cc:75-95):

  [0:6]   average of lower-band cepstra over 3 frames
  [6:22]  higher-band cepstral coefficients
  [22:28] first derivative  (kernel [1, 0, -1])
  [28:34] second derivative (kernel [1, -2, 1])
  [34:40] pitch-lagged cepstral cross-correlation
  [40]    normalized pitch period: 0.01 * (period_48k - 300)
  [41]    spectral variability

The pitch-lagged 20 ms frame is read per stream through K5
(``ops/cuda_window.py``). The Vorbis window, the (20, 240) Opus-band
matrix and the DCT table are registered buffers.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from webrtc_audio_processing_tpu_torch.models.agc2.rnn_vad import (
    pitch as pitch_mod,
)
from webrtc_audio_processing_tpu_torch.ops import cuda_window, mixed_fft

NUM_BANDS = 22
NUM_LOWER_BANDS = 6
CEPSTRAL_HISTORY = 8
OPUS_BANDS_24K = 20
FEATURE_VECTOR_SIZE = 42
SILENCE_THRESHOLD = 0.04  # spectral_features.cc:32
FRAME_20MS = pitch_mod.FRAME_20MS_24K  # 480
FRAME_10MS = pitch_mod.FRAME_10MS_24K  # 240
BUF_SIZE = pitch_mod.BUF_SIZE_24K  # 864
NUM_LPC = 5  # lp_residual.h kNumLpcCoefficients
DCT_SCALE = 0.301511345  # spectral_features_internal.cc:176
_F32_MAX = float(np.finfo(np.float32).max)


def _vorbis_window() -> np.ndarray:
    """ComputeScaledHalfVorbisWindow (spectral_features.cc:58-69), scaled by
    1/480, mirrored to the full frame (:80-88)."""
    half = np.arange(FRAME_20MS // 2)
    s = np.sin(0.5 * np.pi * (half + 0.5) / (FRAME_20MS // 2))
    hw = (np.sin(0.5 * np.pi * s * s) / FRAME_20MS).astype(np.float32)
    return np.concatenate([hw, hw[::-1]])


_BAND_SIZES = [4] * 8 + [8] * 4 + [16] * 3 + [24] * 2 + [32, 48]  # 19 bands


def _band_matrix() -> np.ndarray:
    """Triangular Opus-band aggregation (spectral_features_internal.cc:30-131)
    as a dense (20, 240) matrix."""
    m = np.zeros((OPUS_BANDS_24K, FRAME_20MS // 2), np.float32)
    k = 0
    for i, size in enumerate(_BAND_SIZES):
        for j in range(size):
            w = j / size
            m[i, k] += 1.0 - w
            m[i + 1, k] += w
            k += 1
    m[0] *= 2.0  # first band gets half contribution otherwise (:122)
    return m


def _dct_table() -> np.ndarray:
    """ComputeDctTable (spectral_features_internal.cc:160-170): T[j, i]."""
    i = np.arange(NUM_BANDS)
    t = np.cos((i[:, None] + 0.5) * i[None, :] * np.pi / NUM_BANDS)
    t[:, 0] *= np.sqrt(0.5)
    return t.astype(np.float32)


@dataclass
class FeatureState:
    pitch_buffer: torch.Tensor  # (B, 864)
    cepstral_history: torch.Tensor  # (B, 8, 22), row 0 = newest
    last_pitch_period_48k: torch.Tensor  # (B,) int32
    last_pitch_strength: torch.Tensor  # (B,)


def init_state(batch: int, device) -> FeatureState:
    f32 = dict(dtype=torch.float32, device=device)
    return FeatureState(
        pitch_buffer=torch.zeros((batch, BUF_SIZE), **f32),
        cepstral_history=torch.zeros((batch, CEPSTRAL_HISTORY, NUM_BANDS),
                                     **f32),
        last_pitch_period_48k=torch.zeros(batch, dtype=torch.int32,
                                          device=device),
        last_pitch_strength=torch.zeros(batch, **f32),
    )


def compute_lpc_coefficients(x: torch.Tensor) -> torch.Tensor:
    """ComputeAndPostProcessLpcCoefficients (lp_residual.cc:90-118).

    x: (B, 864). Returns (B, 5) inverse-filter coefficients.
    """
    n = x.shape[1]
    ac = [torch.sum(x[:, : n - lag] * x[:, lag:], dim=1)
          for lag in range(NUM_LPC)]
    empty = ac[0] == 0.0

    # DenoiseAutoCorrelation (:41-52).
    denoise = [float(np.float32(v)) for v in
               (1.0001, 1 - 0.000064, 1 - 0.000256, 1 - 0.000576,
                1 - 0.001024)]
    ac = [a * d for a, d in zip(ac, denoise)]

    # Levinson-Durbin with early termination (:56-88), unrolled with masks.
    lpc = [torch.zeros_like(ac[0]) for _ in range(4)]
    error = ac[0]
    broken = torch.zeros_like(empty)
    for i in range(4):
        rc = ac[i + 1]
        for j in range(i):
            rc = rc + lpc[j] * ac[i - j]
        safe_error = torch.where(
            torch.abs(error) < 1e-6,
            torch.copysign(torch.full_like(error, 1e-6), error), error,
        )
        rc = rc / -safe_error
        new_lpc = list(lpc)
        new_lpc[i] = rc
        for j in range((i + 1) >> 1):
            t1 = new_lpc[j]
            t2 = new_lpc[i - 1 - j]
            new_lpc[j] = t1 + rc * t2
            if i - 1 - j != j:
                new_lpc[i - 1 - j] = t2 + rc * t1
        new_error = error - rc * rc * error
        lpc = [torch.where(broken, a, b) for a, b in zip(lpc, new_lpc)]
        error = torch.where(broken, error, new_error)
        broken = broken | (error < 0.001 * ac[0])

    # Post-processing (:103-117).
    damp = [float(np.float32(v)) for v in (0.9, 0.81, 0.729, 0.6561)]
    pre = [a * d for a, d in zip(lpc, damp)]
    kc = 0.8
    out = torch.stack([
        pre[0] + kc,
        pre[1] + kc * pre[0],
        pre[2] + kc * pre[1],
        pre[3] + kc * pre[2],
        kc * pre[3],
    ], dim=1)
    return torch.where(empty[:, None], torch.zeros_like(out), out)


def compute_lp_residual(lpc: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """ComputeLpResidual (lp_residual.cc:120-140): causal FIR [1, lpc...].

    lpc (B, 5), x (B, N) -> (B, N).
    """
    y = x.clone()
    for k in range(1, NUM_LPC + 1):
        y[:, k:] = y[:, k:] + lpc[:, k - 1: k] * x[:, :-k]
    return y


class FeatureExtractor(nn.Module):
    """FeaturesExtractor::CheckSilenceComputeFeatures
    (features_extraction.cc:56-95)."""

    def __init__(self):
        super().__init__()
        self.register_buffer("window", torch.from_numpy(_vorbis_window()))
        self.register_buffer("band_matrix", torch.from_numpy(_band_matrix()))
        self.register_buffer("dct_table", torch.from_numpy(_dct_table()))
        # Offsets on the first two cepstra and cross-correlation cepstra
        # (spectral_features.cc), and the diagonal that keeps each
        # cepstrum's distance to itself out of the minimum.
        cep = np.zeros(NUM_BANDS, np.float32)
        cep[:2] = (-12.0, -4.0)
        cross = np.zeros(NUM_LOWER_BANDS, np.float32)
        cross[:2] = (-1.3, -0.9)
        self.register_buffer("cepstrum_offsets", torch.from_numpy(cep))
        self.register_buffer("cross_offsets", torch.from_numpy(cross))
        self.register_buffer(
            "self_distance",
            torch.from_numpy(np.eye(CEPSTRAL_HISTORY, dtype=np.float32)
                             * np.float32(_F32_MAX)),
        )

    def _band_energies(self, spec: torch.Tensor) -> torch.Tensor:
        """SpectralCorrelator::ComputeCrossCorrelation
        (spectral_features_internal.cc:102-124): (B, 240) -> (B, 20)."""
        return spec @ self.band_matrix.T

    def _dct(self, x: torch.Tensor, out_size: int) -> torch.Tensor:
        """ComputeDct (spectral_features_internal.cc:172-196)."""
        n = x.shape[1]
        return (x @ self.dct_table[:n, :out_size]) * DCT_SCALE

    @staticmethod
    def _smoothed_log_energies(bands_energy: torch.Tensor) -> torch.Tensor:
        """ComputeSmoothedLogMagnitudeSpectrum
        (spectral_features_internal.cc:133-158)."""
        raw = torch.cat([
            torch.log10(0.01 + bands_energy),
            torch.full((bands_energy.shape[0], NUM_BANDS - OPUS_BANDS_24K),
                       -2.0, dtype=bands_energy.dtype,
                       device=bands_energy.device),
        ], dim=1)
        log_max = torch.full_like(raw[:, 0], -2.0)
        follow = torch.full_like(raw[:, 0], -2.0)
        out = []
        for i in range(NUM_BANDS):
            v = torch.maximum(log_max - 7.0,
                              torch.maximum(follow - 1.5, raw[:, i]))
            log_max = torch.maximum(log_max, v)
            follow = torch.maximum(follow - 1.5, v)
            out.append(v)
        return torch.stack(out, dim=1)

    def forward(self, state: FeatureState, frame_24k: torch.Tensor):
        """frame_24k: (B, 240). Returns (new_state, features (B, 42),
        is_silence (B,)). On silence the reference skips the spectral state
        updates; the old cepstral history is selected instead."""
        pitch_buf = torch.cat([state.pitch_buffer[:, FRAME_10MS:], frame_24k],
                              dim=1)

        lpc = compute_lpc_coefficients(pitch_buf)
        residual = compute_lp_residual(lpc, pitch_buf)
        period_48k, strength = pitch_mod.estimate_pitch(
            residual, state.last_pitch_period_48k, state.last_pitch_strength
        )

        # Reference frame = most recent 20 ms; lagged frame per pitch period,
        # read per stream by K5.
        ref = pitch_buf[:, BUF_SIZE - FRAME_20MS:]
        lag_start = pitch_mod.MAX_PITCH_24K - torch.div(
            period_48k, 2, rounding_mode="floor")
        lagged = cuda_window.take_windows(
            pitch_buf, torch.clamp(lag_start, 0, BUF_SIZE - FRAME_20MS),
            FRAME_20MS,
        )

        half = FRAME_20MS // 2
        ref_spec = mixed_fft.rfft480(ref * self.window)[:, :half]
        ref_energy = self._band_energies(ref_spec.real ** 2
                                         + ref_spec.imag ** 2)
        is_silence = torch.sum(ref_energy, dim=1) < SILENCE_THRESHOLD

        lag_spec = mixed_fft.rfft480(lagged * self.window)[:, :half]
        lag_energy = self._band_energies(lag_spec.real ** 2
                                         + lag_spec.imag ** 2)

        log_energy = self._smoothed_log_energies(ref_energy)
        cepstrum = self._dct(log_energy, NUM_BANDS)
        cepstrum = cepstrum + self.cepstrum_offsets

        history = torch.cat([cepstrum[:, None],
                             state.cepstral_history[:, :-1]], dim=1)

        # Average / first / second derivative over the 3 newest cepstra
        # (spectral_features.cc:165-183).
        curr, prev1, prev2 = history[:, 0], history[:, 1], history[:, 2]
        lower = slice(0, NUM_LOWER_BANDS)
        average = (curr + prev1 + prev2)[:, lower]
        first_d = (curr - prev2)[:, lower]
        second_d = (curr - 2 * prev1 + prev2)[:, lower]

        # Normalized cepstral cross-correlation (spectral_features.cc:185-202).
        cross = self._band_energies(ref_spec.real * lag_spec.real
                                    + ref_spec.imag * lag_spec.imag)
        cross = cross / torch.sqrt(0.001 + ref_energy * lag_energy)
        cross_cep = self._dct(cross, NUM_LOWER_BANDS)
        cross_cep = cross_cep + self.cross_offsets

        # Variability from pairwise cepstral distances
        # (spectral_features.cc:204-219), recomputed from the ring.
        diffs = history[:, :, None, :] - history[:, None, :, :]
        dists = torch.sum(diffs * diffs, dim=-1)  # (B, 8, 8)
        dists = dists + self.self_distance
        variability = (torch.sum(torch.amin(dists, dim=1), dim=1)
                       / CEPSTRAL_HISTORY - 2.1)

        features = torch.cat([
            average,
            cepstrum[:, NUM_LOWER_BANDS:],
            first_d,
            second_d,
            cross_cep,
            (0.01 * (period_48k.to(torch.float32) - 300))[:, None],
            variability[:, None],
        ], dim=1)

        new_state = FeatureState(
            pitch_buffer=pitch_buf,
            cepstral_history=torch.where(is_silence[:, None, None],
                                         state.cepstral_history, history),
            last_pitch_period_48k=period_48k.to(torch.int32),
            last_pitch_strength=strength,
        )
        return new_state, features, is_silence
