"""Exponential smoothing filter with an init-phase varying time constant.

The port's own copy of ``webrtc_audio_processing_tpu/utils/smoothing_filter.py``
(pure Python and numpy; nothing of it is shared with the JAX package).

Reference: common_audio/smoothing_filter.{h,cc} (SmoothingFilterImpl).
Host-side utility (1 sample/ms model with sparse-sample extrapolation).
"""

from __future__ import annotations

import math


class SmoothingFilter:
    """y[t] = alpha * y[t-1] + (1-alpha) * x, alpha = exp(-1/tau_ms), with
    an increasing alpha(n) = exp(-init_factor^n) during the first
    init_time_ms after the first sample (smoothing_filter.cc:22-38)."""

    def __init__(self, init_time_ms: int):
        self._init_time_ms = init_time_ms
        if init_time_ms == 0:
            self._init_factor = 0.0
            self._init_const = 0.0
        else:
            self._init_factor = init_time_ms ** (-1.0 / init_time_ms)
            self._init_const = init_time_ms - init_time_ms ** (
                1.0 - 1.0 / init_time_ms
            )
        self._init_end_time_ms: int | None = None
        self._last_sample = 0.0
        self._state = 0.0
        self._last_state_time_ms = 0
        self._update_alpha(init_time_ms)

    @property
    def alpha(self) -> float:
        return self._alpha

    def add_sample(self, sample: float, now_ms: int) -> None:
        if self._init_end_time_ms is None:
            # As if this value had been fed since t = -infinity.
            self._state = self._last_sample = sample
            self._init_end_time_ms = now_ms + self._init_time_ms
            self._last_state_time_ms = now_ms
            return
        self._extrapolate(now_ms)
        self._last_sample = sample

    def get_average(self, now_ms: int) -> float | None:
        if self._init_end_time_ms is None:
            return None
        self._extrapolate(now_ms)
        return self._state

    def set_time_constant_ms(self, time_constant_ms: int) -> bool:
        if (self._init_end_time_ms is None
                or self._last_state_time_ms < self._init_end_time_ms):
            return False
        self._update_alpha(time_constant_ms)
        return True

    def _update_alpha(self, time_constant_ms: int) -> None:
        self._alpha = (
            0.0 if time_constant_ms == 0
            else math.exp(-1.0 / time_constant_ms)
        )

    def _extrapolate(self, time_ms: int) -> None:
        assert self._init_end_time_ms is not None
        if time_ms <= self._init_end_time_ms:
            if self._init_time_ms == 0:
                multiplier = 0.0
            elif self._init_time_ms == 1:
                multiplier = math.exp(self._last_state_time_ms - time_ms)
            else:
                multiplier = math.exp(
                    -(
                        self._init_factor
                        ** (self._last_state_time_ms
                            - self._init_end_time_ms)
                        - self._init_factor
                        ** (time_ms - self._init_end_time_ms)
                    )
                    / self._init_const
                )
        else:
            if self._last_state_time_ms < self._init_end_time_ms:
                self._extrapolate(self._init_end_time_ms)
            multiplier = self._alpha ** (
                time_ms - self._last_state_time_ms
            )
        self._state = (
            multiplier * self._state + (1.0 - multiplier) * self._last_sample
        )
        self._last_state_time_ms = time_ms
