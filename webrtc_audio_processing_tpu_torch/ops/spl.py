"""Fixed-point SPL primitives (int32 Q-math with the C semantics).

Port of ``webrtc_audio_processing_tpu/ops/spl.py`` (reference:
common_audio/signal_processing/ — spl_sqrt.c, resample_by_2.c and the
min/max/norm helpers of spl_inl.h), used by AGC1 and the legacy VAD. Every
function is elementwise on int32 tensors of any shape and matches the JAX
package op for op, so results are equal bit for bit:

- int32 products wrap in both; ``>>`` is arithmetic in both, and no shift
  count leaves [0, 31] (PyTorch's CPU and CUDA disagree outside it);
- ``//`` floors in both; ``div_w32_w16`` truncates, as the C code does;
- the JAX package's ``uint32`` views go through int64 here, masked to 32
  bits (PyTorch's uint32 has few CUDA ops).

``downsample_by_2`` is a per-sample recurrence: a Python loop over the
frame's sample pairs on (N,) state rows, one group of elementwise ops a
pair.
"""

from __future__ import annotations

import torch

I32 = torch.int32
WORD32_MAX = 0x7FFFFFFF
WORD32_MIN = -0x80000000
_MASK32 = 0xFFFFFFFF


def _u32(x: torch.Tensor) -> torch.Tensor:
    """The uint32 bit pattern of an int32 tensor, as int64."""
    return x.to(torch.int64) & _MASK32


def _from_u32(u: torch.Tensor) -> torch.Tensor:
    """The int32 whose bit pattern is the low 32 bits of an int64."""
    u = u & _MASK32
    return torch.where(u >= 0x80000000, u - (1 << 32), u).to(I32)


def shl_u32(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """``(x.view(uint32) << n).view(int32)`` for int32 ``x`` and ``n`` in
    [0, 31]."""
    return _from_u32(_u32(x) << n.to(torch.int64))


def norm_u32(x: torch.Tensor) -> torch.Tensor:
    """WebRtcSpl_NormU32: leading zeros of the uint32 pattern of ``x``, by
    the binary search of spl_inl.h (31 for 0, which callers mask)."""
    u = _u32(x)
    zeros = torch.zeros(x.shape, dtype=torch.int64, device=x.device)
    for shift, mask in ((16, 0xFFFF0000), (8, 0xFF000000), (4, 0xF0000000),
                        (2, 0xC0000000), (1, 0x80000000)):
        cond = ((u << zeros) & mask) == 0
        zeros = zeros + cond.to(torch.int64) * shift
    return zeros.to(I32)


def norm_w32(x: torch.Tensor) -> torch.Tensor:
    """WebRtcSpl_NormW32: shifts that normalize a signed int32 (0 for 0)."""
    ax = torch.where(x < 0, ~x, x)
    n = norm_u32(ax) - 1
    return torch.where(x == 0, 0, n).to(I32)


def sat_w32_to_w16(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, -32768, 32767)


def add_sat_w16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.clamp(a + b, -32768, 32767)


def wrap_i16(v: torch.Tensor) -> torch.Tensor:
    """An int16_t narrowing store: the low 16 bits, sign-extended."""
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def div_w32_w16(num: torch.Tensor, den) -> torch.Tensor:
    """WebRtcSpl_DivW32W16: C division, truncating toward zero."""
    if not torch.is_tensor(den):
        den = torch.full_like(num, den)
    q = torch.abs(num) // torch.clamp(torch.abs(den), min=1)
    return torch.where((num < 0) ^ (den < 0), -q, q).to(I32)


def mul_hi16(a: torch.Tensor, b16) -> torch.Tensor:
    """(a * b16) >> 16 for int32 ``a`` and 16-bit ``b16``, by the exact
    hi/lo split (C's ``(int64_t)a * b >> 16``)."""
    hi = a >> 16
    lo = a & 0xFFFF
    return hi * b16 + ((lo * b16) >> 16)


def scalediff32(a16, b32: torch.Tensor, c32: torch.Tensor) -> torch.Tensor:
    """WEBRTC_SPL_SCALEDIFF32(A, B, C) = C + (B >> 16) * A
    + ((0xFFFF & B) * A >> 16), the low product in unsigned 32-bit
    arithmetic with wraparound and a logical shift (resample_by_2.c)."""
    lo = ((((b32 & 0xFFFF).to(torch.int64) * (a16 & _MASK32)) & _MASK32)
          >> 16).to(I32)
    return c32 + (b32 >> 16) * a16 + lo


def agc_scalediff32(a, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """AGC_SCALEDIFF32(A, B, C) (digital_agc.cc:64-65), all signed."""
    return c + (b >> 16) * a + (((b & 0xFFFF) * a) >> 16)


def agc_mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """AGC_MUL32(A, B) = (B >> 13) * A + ((0x1FFF & B) * A >> 13)
    (digital_agc.cc:61), signed."""
    return (b >> 13) * a + (((b & 0x1FFF) * a) >> 13)


def _sqrt_local(a: torch.Tensor) -> torch.Tensor:
    """WebRtcSpl_SqrtLocal (spl_sqrt.c:17-63), elementwise."""
    b = a // 2
    b = b - 0x40000000
    x_half = b >> 16
    x_half = ((x_half + 0x8000) & 0xFFFF) - 0x8000
    b = b + 0x40000000
    b = b + 0x40000000
    x2 = x_half * x_half * 2
    A = -x2
    b = b + (A >> 1)
    A = A >> 16
    A = A * A * 2
    t16 = torch.remainder((A >> 16) + 0x8000, 0x10000) - 0x8000
    b = b + (-20480) * t16 * 2
    A = x_half * t16 * 2
    t16 = torch.remainder((A >> 16) + 0x8000, 0x10000) - 0x8000
    b = b + 28672 * t16 * 2
    t16 = torch.remainder((x2 >> 16) + 0x8000, 0x10000) - 0x8000
    A = x_half * t16 * 2
    b = b + (A >> 1)
    return b + 32768


def sqrt_i32(value: torch.Tensor) -> torch.Tensor:
    """WebRtcSpl_Sqrt (spl_sqrt.c:66-150), elementwise."""
    v = value
    A = torch.where(v < 0, torch.where(v == WORD32_MIN, WORD32_MAX, -v), v)
    is_zero = A == 0
    A_safe = torch.clamp(A, min=1)
    sh = norm_w32(A_safe)
    A_n = shl_u32(A_safe, sh)
    A_n = torch.where(A_n < (WORD32_MAX - 32767), A_n + 32768, WORD32_MAX)
    x_norm = A_n >> 16
    nshift = sh // 2
    A2 = torch.abs(x_norm << 16)
    A3 = _sqrt_local(A2)
    even = 2 * nshift == sh
    t16 = A3 >> 16
    Ae = 23170 * t16 * 2
    Ae = Ae + 32768
    Ae = Ae & 0x7FFF0000
    Ae = Ae >> 15
    Ao = A3 >> 16
    out = torch.where(even, Ae, Ao)
    out = out & 0xFFFF
    out = out >> nshift
    return torch.where(is_zero, 0, out).to(I32)


# Allpass decimator coefficients (resample_by_2.c:58-59).
_ALLPASS1 = (3284, 24441, 49528)
_ALLPASS2 = (12199, 37471, 60255)


def downsample_by_2(x: torch.Tensor, filt_state: torch.Tensor):
    """WebRtcSpl_DownsampleBy2 (resample_by_2.c:71-128) on N rows.

    x: (N, L) int32 (int16-valued), filt_state: (N, 8) int32. Returns
    (y (N, L // 2) int32, new_state (N, 8))."""
    s = list(filt_state.unbind(-1))
    ev, od = x[:, 0::2], x[:, 1::2]
    outs = []
    for k in range(x.shape[1] // 2):
        s0, s1, s2, s3, s4, s5, s6, s7 = s
        in32 = ev[:, k] * 1024
        t1 = scalediff32(_ALLPASS2[0], in32 - s1, s0)
        s0 = in32
        t2 = scalediff32(_ALLPASS2[1], t1 - s2, s1)
        s1 = t1
        s3 = scalediff32(_ALLPASS2[2], t2 - s3, s2)
        s2 = t2
        in32 = od[:, k] * 1024
        t1 = scalediff32(_ALLPASS1[0], in32 - s5, s4)
        s4 = in32
        t2 = scalediff32(_ALLPASS1[1], t1 - s6, s5)
        s5 = t1
        s7 = scalediff32(_ALLPASS1[2], t2 - s7, s6)
        s6 = t2
        outs.append(sat_w32_to_w16((s3 + s7 + 1024) >> 11))
        s = [s0, s1, s2, s3, s4, s5, s6, s7]
    return torch.stack(outs, -1), torch.stack(s, -1)
