"""Three-band filter bank (48 kHz -> 3 x 16 kHz) with DCT modulation.

Port of ``webrtc_audio_processing_tpu/ops/three_band.py`` (reference:
modules/audio_processing/three_band_filter_bank.cc): a sparsity-4 polyphase
FIR with 10 non-zero modulated filters of 4 taps each, DCT modulation to
the centre frequencies [1/12, 3/12, 5/12], non-perfect reconstruction.

Each filter's 4 taps read shifted 160-sample slices of the state-extended
subsampled signal. The port gathers all 10 x 4 slices with one index
tensor, then contracts taps and DCT modulation as two products, instead of
the JAX version's 40 separate slice-multiply-adds.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

NUM_BANDS = 3
SPARSITY = 4
STRIDE = 4
FILTER_SIZE = 4
MEMORY_SIZE = FILTER_SIZE * STRIDE - 1  # 15
FULL_BAND_SIZE = 480
SPLIT_BAND_SIZE = 160
NUM_NON_ZERO = SPARSITY * NUM_BANDS - 2  # 10
_EXT = MEMORY_SIZE + SPLIT_BAND_SIZE  # 175

# Low-pass prototype, polyphase rows (three_band_filter_bank.cc:79-89).
FILTER_COEFFS = np.array(
    [
        [-0.00047749, -0.00496888, +0.16547118, +0.00425496],
        [-0.00173287, -0.01585778, +0.14989004, +0.00994113],
        [-0.00304815, -0.02536082, +0.12154542, +0.01157993],
        [-0.00346946, -0.02587886, +0.04760441, +0.00607594],
        [-0.00154717, -0.01136076, +0.01387458, +0.00186353],
        [+0.00186353, +0.01387458, -0.01136076, -0.00154717],
        [+0.00607594, +0.04760441, -0.02587886, -0.00346946],
        [+0.00983212, +0.08543175, -0.02982767, -0.00383509],
        [+0.00994113, +0.14989004, -0.01585778, -0.00173287],
        [+0.00425496, +0.16547118, -0.00496888, -0.00047749],
    ],
    np.float32,
)

_SQRT3 = np.sqrt(3.0, dtype=np.float64)
# DCT modulation per non-zero filter (three_band_filter_bank.cc:95-106).
DCT_MODULATION = np.array(
    [
        [2, 2, 2],
        [_SQRT3, 0, -_SQRT3],
        [1, -2, 1],
        [-1, 2, -1],
        [-_SQRT3, 0, _SQRT3],
        [-2, -2, -2],
        [-_SQRT3, 0, _SQRT3],
        [-1, 2, -1],
        [1, -2, 1],
        [_SQRT3, 0, -_SQRT3],
    ],
    np.float32,
)

# The 12 (downsampling, shift) combos mapped to non-zero filter indices,
# skipping kZeroFilterIndex1=3 and kZeroFilterIndex2=9
# (three_band_filter_bank.cc:91-93, :199-209); sorted by filter index.
_COMBOS = []  # (filter_index, downsampling_index, in_shift)
for _shift in range(STRIDE):
    for _ds in range(NUM_BANDS):
        _index = _ds + _shift * NUM_BANDS
        if _index in (3, 9):
            continue
        _fi = _index if _index < 3 else (_index - 1 if _index < 9 else _index - 2)
        _COMBOS.append((_fi, _ds, _shift))
_COMBOS.sort()


def _tap_starts() -> np.ndarray:
    """(10, 4) start of tap i's slice for filter fi: 15 - shift - 4i."""
    starts = np.zeros((NUM_NON_ZERO, FILTER_SIZE), np.int64)
    for fi, _, shift in _COMBOS:
        starts[fi] = MEMORY_SIZE - shift - STRIDE * np.arange(FILTER_SIZE)
    return starts


def _analysis_index() -> np.ndarray:
    """(10, 4, 160) flat indices into the (3 * 175) extended branches."""
    ds = np.array([d for _, d, _ in _COMBOS])
    k = np.arange(SPLIT_BAND_SIZE)
    return (ds[:, None, None] * _EXT + _tap_starts()[:, :, None]
            + k[None, None, :])


def _synthesis_index() -> np.ndarray:
    """(10, 4, 160) flat indices into the (10 * 175) extended filters."""
    fi = np.arange(NUM_NON_ZERO)
    k = np.arange(SPLIT_BAND_SIZE)
    return (fi[:, None, None] * _EXT + _tap_starts()[:, :, None]
            + k[None, None, :])


def _upsampling_onehot() -> np.ndarray:
    """(10, 3): filter fi feeds upsampling branch up."""
    m = np.zeros((NUM_NON_ZERO, NUM_BANDS), np.float32)
    for fi, up, _ in _COMBOS:
        m[fi, up] = 1.0
    return m


@dataclass
class ThreeBandState:
    """analysis: (B, 3, 15, C) per downsampling branch; synthesis:
    (B, 10, 15, C) per filter."""

    analysis: torch.Tensor
    synthesis: torch.Tensor


def init_state(batch: int, num_channels: int, device) -> ThreeBandState:
    f32 = dict(dtype=torch.float32, device=device)
    return ThreeBandState(
        analysis=torch.zeros((batch, NUM_BANDS, MEMORY_SIZE, num_channels),
                             **f32),
        synthesis=torch.zeros((batch, NUM_NON_ZERO, MEMORY_SIZE,
                               num_channels), **f32),
    )


class ThreeBandFilterBank(nn.Module):
    """ThreeBandFilterBank::{Analysis, Synthesis}
    (three_band_filter_bank.cc:173-278)."""

    def __init__(self):
        super().__init__()
        self.register_buffer("filter_coeffs", torch.from_numpy(FILTER_COEFFS))
        self.register_buffer("dct_modulation",
                             torch.from_numpy(DCT_MODULATION))
        self.register_buffer("upsampling", torch.from_numpy(_upsampling_onehot()))
        self.register_buffer("analysis_index",
                             torch.from_numpy(_analysis_index()))
        self.register_buffer("synthesis_index",
                             torch.from_numpy(_synthesis_index()))

    def analysis(self, x: torch.Tensor, state: ThreeBandState):
        """(B, 480, C) -> ((B, 3, 160, C) bands, new state)."""
        B, _, C = x.shape
        # Serial-to-parallel: in_sub[ds, k] = x[(2 - ds) + 3k].
        par = x.reshape(B, SPLIT_BAND_SIZE, NUM_BANDS, C)
        in_sub = torch.flip(par.permute(0, 2, 1, 3), dims=(1,))
        ext = torch.cat([state.analysis, in_sub], dim=2)  # (B, 3, 175, C)
        taps = ext.reshape(B, NUM_BANDS * _EXT, C)[:, self.analysis_index]
        filtered = torch.einsum("bfitc,fi->bftc", taps, self.filter_coeffs)
        bands = torch.einsum("bftc,fj->bjtc", filtered, self.dct_modulation)
        new_state = ThreeBandState(
            analysis=in_sub[:, :, -MEMORY_SIZE:], synthesis=state.synthesis
        )
        return bands, new_state

    def synthesis(self, bands: torch.Tensor, state: ThreeBandState):
        """(B, 3, 160, C) bands -> ((B, 480, C) signal, new state)."""
        B = bands.shape[0]
        C = bands.shape[-1]
        in_sub = torch.einsum("fj,bjtc->bftc", self.dct_modulation, bands)
        ext = torch.cat([state.synthesis, in_sub], dim=2)  # (B, 10, 175, C)
        taps = ext.reshape(B, NUM_NON_ZERO * _EXT, C)[:, self.synthesis_index]
        filtered = torch.einsum("bfitc,fi->bftc", taps, self.filter_coeffs)
        out_par = torch.einsum("bftc,fu->butc", filtered, self.upsampling)
        # Parallel-to-serial with x3 gain: out[up + 3k] = 3 * out_par[up][k].
        out = out_par.permute(0, 2, 1, 3).reshape(B, FULL_BAND_SIZE, C)
        out = out * float(NUM_BANDS)
        new_state = ThreeBandState(
            analysis=state.analysis, synthesis=in_sub[:, :, -MEMORY_SIZE:]
        )
        return out, new_state
