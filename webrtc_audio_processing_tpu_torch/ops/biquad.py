"""Cascaded direct-form-1 biquad filtering.

Port of ``webrtc_audio_processing_tpu/ops/biquad.py`` (reference:
modules/audio_processing/utility/cascaded_biquad_filter.cc:58-84 and the
high-pass coefficient tables of high_pass_filter.cc:25-56).

Every static-coefficient cascade goes to K1 (``ops/cuda_biquad.py``), as the
JAX package routes it to its Pallas kernel: streams x channels become the
kernel's lanes, time-major. Per-channel state is the (x[-1], x[-2], y[-1],
y[-2]) quadruple per section, the reference's ``BiQuad::{x, y}`` members.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from webrtc_audio_processing_tpu_torch.ops import cuda_biquad


@dataclass
class BiquadCascadeState:
    """x, y: (B, num_sections, 2, C) — previous two inputs / outputs; a
    single-signal cascade drops the channel axis: (B, num_sections, 2)."""

    x: torch.Tensor
    y: torch.Tensor


def init_state(num_sections: int, batch: int, num_channels: int | None,
               device) -> BiquadCascadeState:
    """``num_channels=None`` makes the state of one signal per stream."""
    shape = (batch, num_sections, 2)
    if num_channels is not None:
        shape += (num_channels,)
    z = torch.zeros(shape, dtype=torch.float32, device=device)
    return BiquadCascadeState(x=z, y=z.clone())


def pack_coeffs(coeffs_b, coeffs_a) -> np.ndarray:
    """(K, 3) b and (K, 2) a -> (K, 5) float32 rows [b0, b1, b2, a1, a2]."""
    return np.concatenate(
        [np.asarray(coeffs_b, np.float32), np.asarray(coeffs_a, np.float32)],
        axis=1,
    )


def process(coeffs: torch.Tensor, state: BiquadCascadeState, x: torch.Tensor):
    """Run the cascade over ``x`` (B, T, C) with ``coeffs`` (K, 5); a
    single signal per stream is ``x`` (B, T) with a channel-less state.

    Returns (new_state, y) shaped like ``x``.
    """
    if x.dim() == 2:
        st = BiquadCascadeState(x=state.x[..., None], y=state.y[..., None])
        st, y = process(coeffs, st, x[..., None])
        return BiquadCascadeState(x=st.x[..., 0], y=st.y[..., 0]), y[..., 0]
    B, T, C = x.shape
    K = coeffs.shape[0]
    x_t = x.permute(1, 0, 2).reshape(T, B * C)
    # (B, K, 4, C) rows [x1, x2, y1, y2] -> (4K, B*C).
    st = torch.cat([state.x, state.y], dim=2)
    st = st.permute(1, 2, 0, 3).reshape(4 * K, B * C)
    st_new, y_t = cuda_biquad.cascade(coeffs, st, x_t)
    st_new = st_new.reshape(K, 4, B, C).permute(2, 0, 1, 3)
    y = y_t.reshape(T, B, C).permute(1, 0, 2)
    return BiquadCascadeState(x=st_new[:, :, :2], y=st_new[:, :, 2:]), y


# High-pass filter coefficient tables (high_pass_filter.cc:25-56): three
# cascaded sections per rate, float32 as the JAX package stores them.
HPF_COEFFS = {
    16000: (
        np.array(
            [
                [0.8773539420715290582, -1.754683920749088077, 0.8773539420715289472],
                [1.0, -1.999810143464515022, 1.0],
                [1.0, -1.999669231394235469, 1.0],
            ],
            np.float32,
        ),
        np.array(
            [
                [-1.881687317862849707, 0.8880584644559580410],
                [-1.976035417167170793, 0.9779708644868606582],
                [-1.994265767864654482, 0.9954861594635392441],
            ],
            np.float32,
        ),
    ),
    32000: (
        np.array(
            [
                [0.9102055685511306615, -1.820404922871161624, 0.9102055685511306615],
                [1.0, -1.999952541587768806, 1.0],
                [1.0, -1.999917315632020021, 1.0],
            ],
            np.float32,
        ),
        np.array(
            [
                [-1.940710875829138482, 0.9423512845457852061],
                [-1.988434609801665420, 0.9889212529819323416],
                [-1.997434723613889629, 0.9977401885079651978],
            ],
            np.float32,
        ),
    ),
    48000: (
        np.array(
            [
                [0.9213790163564168, -1.8427552370064049, 0.9213790163564168],
                [1.0, -1.9999789078432082, 1.0],
                [1.0, -1.9999632520325810, 1.0],
            ],
            np.float32,
        ),
        np.array(
            [
                [-1.9604500061078971, 0.9611862979079667],
                [-1.9923834169149972, 0.9926001112941157],
                [-1.9983570340145236, 0.9984928491805198],
            ],
            np.float32,
        ),
    ),
}
