"""Approximate transcendentals matching the reference's ns/fast_math.cc.

Port of ``webrtc_audio_processing_tpu/ops/fast_math.py``. ``fast_log2``
reinterprets the float32 bit pattern as an integer (ns/fast_math.cc:26-41);
its error (up to ~0.09 in log2) is part of the NS numerics, so the bit trick
is reproduced exactly. All functions are elementwise, float32.
"""

from __future__ import annotations

import numpy as np
import torch

# FastLog2f constants (ns/fast_math.cc:36-38), as float32 values.
_ONE_BY_2POW23 = float(np.float32(1.1920929e-7))
_EXP_BIAS = float(np.float32(126.942695))

_LN2 = float(np.float32(0.6931471805599453))
_LOG10_E = float(np.float32(0.4342944819032518))

# fast_log2(10.0f) evaluated exactly as float32: bits(10.0) = 0x41200000.
_FAST_LOG2_10 = float(
    np.float32(0x41200000) * np.float32(1.1920929e-7) - np.float32(126.942695)
)


def fast_log2(x: torch.Tensor) -> torch.Tensor:
    """Bit-pattern log2 (ns/fast_math.cc:26-41). Requires x > 0."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    # The reference reads the bits as uint32; widen before converting.
    unsigned = bits.to(torch.int64) & 0xFFFFFFFF
    return unsigned.to(torch.float32) * _ONE_BY_2POW23 - _EXP_BIAS


def log_approx(x: torch.Tensor) -> torch.Tensor:
    """LogApproximation (ns/fast_math.cc:55-58): fast_log2(x) * ln(2)."""
    return fast_log2(x) * _LN2


def pow_approx(x: torch.Tensor, p) -> torch.Tensor:
    """PowApproximation (ns/fast_math.cc:51-53): 2^(p * fast_log2(x))."""
    return torch.exp2(p * fast_log2(x))


def exp_approx(x: torch.Tensor) -> torch.Tensor:
    """ExpApproximation (ns/fast_math.cc:66-69): 10^(x*log10(e)) via
    pow_approx."""
    return torch.exp2(x.to(torch.float32) * _LOG10_E * _FAST_LOG2_10)
