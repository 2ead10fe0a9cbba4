"""FastApproxLog2f (aec3_common.cc): bit-trick log2, bit for bit.

Port of ``aec_state.fast_approx_log2`` and ``reverb_decay_estimator._log2f``
of the JAX package, which compute the same thing: the float32 exponent plus
the mantissa read linearly.
"""

from __future__ import annotations

import torch


def fast_approx_log2(x: torch.Tensor) -> torch.Tensor:
    x = torch.clamp(x.to(torch.float32), min=1e-30).contiguous()
    bits = x.view(torch.int32)
    exp = (bits >> 23) - 127
    mant = 1.0 + (bits & 0x7FFFFF).to(torch.float32) * (1.0 / 8388608.0)
    return exp.to(torch.float32) + mant - 1.0
