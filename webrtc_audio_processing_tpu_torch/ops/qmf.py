"""Two-band QMF analysis and synthesis (all-pass polyphase pair) on K1.

Port of ``webrtc_audio_processing_tpu/ops/qmf.py`` (reference:
common_audio/signal_processing/splitting_filter.c, WebRtcSpl_AnalysisQMF
:134-167, WebRtcSpl_SynthesisQMF :169-204, WebRtcSpl_AllPassQMF :47-131),
the 32 kHz two-band split of modules/audio_processing/splitting_filter.cc.

Each branch is a cascade of three first-order all-pass sections
``y[n] = x[n-1] + a (x[n] - y[n-1])``. Such a section is a direct-form-1
biquad with the row [b0, b1, b2, a1, a2] = [a, 1, 0, a, 0], so a branch is
one call of K1 (``ops/cuda_biquad.py``) with three sections over the
(160, B * C) time-major half-rate signal: a QMF direction is two K1
launches and a few copies, not a loop over samples. K1's all-pass form
evaluates a section as ``fma(a, x - y1, x1)``, the order XLA:CPU gives
the JAX package's scan. Its biquad form, ``fma(-a, y1, fma(a, x, x1))``,
is within JAX's own bar of the JAX QMF, but the split-band HPF's poles
near the unit circle amplify any last-bit difference a few hundred times
downstream.

State: per branch (B, 3, 2, C), each section's (x[-1], y[-1]) as in the
JAX package (the reference's 6-word ``filter_state`` per band,
splitting_filter.h:30). K1 takes (4K, M) rows [x1, x2, y1, y2]; x2 and y2
multiply by zero here, so they enter as zeros and are dropped after.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from webrtc_audio_processing_tpu_torch.ops import cuda_biquad

# QMF all-pass coefficients (splitting_filter.c:25-28).
ALLPASS_COEF_1 = (0.0979309082, 0.5643005371, 0.8737335205)
ALLPASS_COEF_2 = (0.32551574707, 0.74862670898, 0.96145629882)
NUM_SECTIONS = 3


def allpass_rows(coefs) -> np.ndarray:
    """(K, 5) float32 K1 rows [a, 1, 0, a, 0] of the all-pass sections."""
    a = np.asarray(coefs, np.float32)
    one, zero = np.ones_like(a), np.zeros_like(a)
    return np.stack([a, one, zero, a, zero], axis=1)


@dataclass
class QmfState:
    """state1, state2: (B, 3, 2, C), per section (x[-1], y[-1]) of branch
    1 and branch 2."""

    state1: torch.Tensor
    state2: torch.Tensor


def init_state(batch: int, num_channels: int, device) -> QmfState:
    shape = (batch, NUM_SECTIONS, 2, num_channels)
    return QmfState(
        state1=torch.zeros(shape, dtype=torch.float32, device=device),
        state2=torch.zeros(shape, dtype=torch.float32, device=device),
    )


def _to_rows(leaf: torch.Tensor) -> torch.Tensor:
    """(B, K, 2, C) (x1, y1) per section -> K1's (4K, B * C) rows
    [x1, x2, y1, y2], x2 and y2 zero."""
    B, K, _, C = leaf.shape
    rows = leaf.new_zeros((K, 2, 2, B, C))  # section, (x, y), lag, lane
    rows[:, :, 0] = leaf.permute(1, 2, 0, 3)
    return rows.view(4 * K, B * C)


def _from_rows(rows: torch.Tensor, B: int, C: int) -> torch.Tensor:
    """K1's (4K, B * C) rows -> (B, K, 2, C) (x1, y1) per section."""
    K = rows.shape[0] // 4
    return rows.view(K, 2, 2, B, C)[:, :, 0].permute(2, 0, 1, 3)


class Qmf(nn.Module):
    """WebRtcSpl_AnalysisQMF and WebRtcSpl_SynthesisQMF over B x C lanes."""

    def __init__(self):
        super().__init__()
        self.register_buffer("rows1",
                             torch.from_numpy(allpass_rows(ALLPASS_COEF_1)))
        self.register_buffer("rows2",
                             torch.from_numpy(allpass_rows(ALLPASS_COEF_2)))

    @staticmethod
    def _chain(rows, x_t, leaf):
        """One branch: the (T, B * C) signal through three all-pass
        sections on K1. Returns (y_t, new leaf)."""
        B, C = leaf.shape[0], leaf.shape[-1]
        st, y_t = cuda_biquad.cascade(rows, _to_rows(leaf), x_t,
                                      allpass=True)
        return y_t, _from_rows(st, B, C)

    def analysis(self, x: torch.Tensor, state: QmfState):
        """(B, 2N, C) full rate -> ((B, 2, N, C) low and high band, state).

        Even samples feed branch 2, odd samples branch 1;
        low = (f1 + f2) / 2, high = (f1 - f2) / 2.
        """
        B, n2, C = x.shape
        n = n2 // 2
        # (2, N, B * C) time-major: [0] the even samples, [1] the odd ones.
        par = x.reshape(B, n, 2, C).permute(2, 1, 0, 3).reshape(2, n, B * C)
        f1, s1 = self._chain(self.rows1, par[1], state.state1)
        f2, s2 = self._chain(self.rows2, par[0], state.state2)
        low = ((f1 + f2) * 0.5).view(n, B, C).permute(1, 0, 2)
        high = ((f1 - f2) * 0.5).view(n, B, C).permute(1, 0, 2)
        return torch.stack([low, high], dim=1), QmfState(state1=s1,
                                                         state2=s2)

    def synthesis(self, bands: torch.Tensor, state: QmfState):
        """(B, 2, N, C) low and high band -> ((B, 2N, C) full rate, state).

        low + high through the COEF_2 sections (state1) gives the odd
        samples, low - high through the COEF_1 sections (state2) the even
        ones; the output is clamped to [-32768, 32767] like the
        reference.
        """
        B, _, n, C = bands.shape
        t = bands.permute(1, 2, 0, 3).reshape(2, n, B * C)
        low, high = t[0], t[1]
        f1, s1 = self._chain(self.rows2, low + high, state.state1)
        f2, s2 = self._chain(self.rows1, low - high, state.state2)
        even = f2.view(n, B, C).permute(1, 0, 2)
        odd = f1.view(n, B, C).permute(1, 0, 2)
        out = torch.stack([even, odd], dim=2).view(B, 2 * n, C)
        return (torch.clamp(out, -32768.0, 32767.0),
                QmfState(state1=s1, state2=s2))
