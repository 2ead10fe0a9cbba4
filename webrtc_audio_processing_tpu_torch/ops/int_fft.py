"""Bit-exact int16 radix-2 FFT (the SPL fixed-point FFT the AECM uses).

Port of ``webrtc_audio_processing_tpu/ops/int_fft.py`` (reference:
common_audio/signal_processing/complex_fft.c mode 1, CFFTSFT=14, CFFTRND=1,
CFFTRND2=16384, the IFFT's per-stage data-dependent scaling; real_fft.c;
complex_bit_reverse.c; complex_fft_tables.h, whose kSinTable1024[i] is
trunc(32767*sin(2*pi*i/1024))).

Each butterfly stage is a static reshape into (blocks, 2, l) halves over
any leading batch axes. The arithmetic is int32 with explicit int16
wraparound, as C's (int16_t) casts do; ``>>`` is arithmetic, and every
shift count lies in [0, 31]. The IFFT's renormalization shift is a per-row
tensor, and so is the accumulated count it returns: nothing reads it on
the host. The bit reversal and the twiddles are constant tables copied to
the device once (``ops.batch.const``).
"""

from __future__ import annotations

import numpy as np
import torch

from webrtc_audio_processing_tpu_torch.ops import batch as batch_ops

I32 = torch.int32

SIN_1024 = np.trunc(32767.0 * np.sin(2.0 * np.pi * np.arange(1024) / 1024.0)
                    ).astype(np.int32)


def _bit_reverse_perm(order: int) -> np.ndarray:
    n = 1 << order
    idx = np.arange(n)
    rev = np.zeros(n, np.int64)
    for b in range(order):
        rev |= ((idx >> b) & 1) << (order - 1 - b)
    return rev


def wrap16(v: torch.Tensor) -> torch.Tensor:
    """An int16_t narrowing store: the low 16 bits, sign-extended."""
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def _stage_geometry(order: int):
    """Static butterfly geometry per stage: (l, twiddle indices (l,))."""
    out = []
    l, k = 1, 9
    n = 1 << order
    while l < n:
        out.append((l, np.arange(l) << k))
        k -= 1
        l <<= 1
    return out


def _const(values, device, dtype=I32):
    return batch_ops.const(tuple(int(v) for v in values), dtype, device)


def _permute(x: torch.Tensor, order: int) -> torch.Tensor:
    return x.index_select(-1, _const(_bit_reverse_perm(order), x.device,
                                     torch.int64))


def _halves(x: torch.Tensor, n: int, l: int):
    r = x.reshape(x.shape[:-1] + (n // (2 * l), 2, l))
    return r[..., 0, :], r[..., 1, :]


def _join(a: torch.Tensor, b: torch.Tensor, shape) -> torch.Tensor:
    return torch.stack([a, b], dim=-2).reshape(shape)


def complex_fft_i16(re: torch.Tensor, im: torch.Tensor, order: int):
    """WebRtcSpl_ComplexFFT mode 1 (complex_fft.c:80-140), the bit reversal
    included (the real wrapper calls ComplexBitReverse first).

    re, im: (..., n) int32 holding int16 values. Returns the transformed
    (re, im), int16-valued: 1/2 per stage, rounded to nearest at Q14."""
    n = 1 << order
    re, im = _permute(re, order), _permute(im, order)
    for l, jidx in _stage_geometry(order):
        wr = _const(SIN_1024[jidx + 256], re.device)
        wi = _const(-SIN_1024[jidx], re.device)
        ar, br = _halves(re, n, l)
        ai, bi = _halves(im, n, l)
        tr = (wr * br - wi * bi + 1) >> 1  # CFFTRND, >> (15 - CFFTSFT)
        ti = (wr * bi + wi * br + 1) >> 1
        qr, qi = ar << 14, ai << 14  # * (1 << CFFTSFT)
        shape = re.shape
        re = _join(wrap16((qr + tr + 16384) >> 15),  # CFFTRND2, 1 + CFFTSFT
                   wrap16((qr - tr + 16384) >> 15), shape)
        im = _join(wrap16((qi + ti + 16384) >> 15),
                   wrap16((qi - ti + 16384) >> 15), shape)
    return re, im


def complex_ifft_i16(re: torch.Tensor, im: torch.Tensor, order: int):
    """WebRtcSpl_ComplexIFFT mode 1 (complex_fft.c:142-268).

    Each stage first renormalizes by 0-2 extra right shifts from the row's
    max |value| (thresholds 13573, 27146). Returns (re, im, scale): scale
    is the accumulated shift count, (...,) int32, the C return value."""
    n = 1 << order
    re, im = _permute(re, order), _permute(im, order)
    scale = torch.zeros(re.shape[:-1], dtype=I32, device=re.device)
    for l, jidx in _stage_geometry(order):
        mx = torch.maximum(re.abs().amax(-1), im.abs().amax(-1))
        shift = (mx > 13573).to(I32) + (mx > 27146).to(I32)
        scale = scale + shift
        round2 = (8192 << shift)[..., None, None]  # doubled per extra shift
        sh = (shift + 14)[..., None, None]  # shift + CIFFTSFT
        wr = _const(SIN_1024[jidx + 256], re.device)
        wi = _const(SIN_1024[jidx], re.device)  # +sin for the inverse
        shape = re.shape
        ar, br = _halves(re, n, l)
        ai, bi = _halves(im, n, l)
        tr = (wr * br - wi * bi + 1) >> 1  # CIFFTRND, >> (15 - CIFFTSFT)
        ti = (wr * bi + wi * br + 1) >> 1
        qr, qi = ar << 14, ai << 14
        re = _join(wrap16((qr + tr + round2) >> sh),
                   wrap16((qr - tr + round2) >> sh), shape)
        im = _join(wrap16((qi + ti + round2) >> sh),
                   wrap16((qi - ti + round2) >> sh), shape)
    return re, im, scale


def real_forward_fft_i16(x: torch.Tensor, order: int = 7):
    """WebRtcSpl_RealForwardFFT (real_fft.c:47-73).

    x: (..., n) int32, int16-valued. Returns (re, im), each
    (..., n // 2 + 1): the first n + 2 int16 outputs of the complex FFT."""
    n = 1 << order
    re, im = complex_fft_i16(x, torch.zeros_like(x), order)
    return re[..., : n // 2 + 1], im[..., : n // 2 + 1]


def real_inverse_fft_i16(re: torch.Tensor, im: torch.Tensor, order: int = 7):
    """WebRtcSpl_RealInverseFFT (real_fft.c:75-105).

    re, im: (..., n // 2 + 1) int16-valued spectra. Builds the conjugate
    symmetric upper half, runs the int IFFT and returns (x (..., n),
    scale (...,)): the real output and the accumulated shift."""
    n = 1 << order
    upper = torch.flip(re[..., 1: n // 2], [-1])
    upper_im = torch.flip(im[..., 1: n // 2], [-1])
    full_re = torch.cat([re, upper], -1)
    full_im = torch.cat([im, wrap16(-upper_im)], -1)
    out_re, _, scale = complex_ifft_i16(full_re, full_im, order)
    return out_re, scale
