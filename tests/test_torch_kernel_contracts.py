"""The contracts that K1's and K5's kernels rest on, checked on the CPU.

- K1's kernel evaluates each multiply-add of the cascade as one float32
  FFMA (a single rounding). Its plain twin rounds the double sum of the
  exact product and c to float, which rounds twice. The two agree on every
  multiply-add the twin does on the port's tables (HPF at 16, 32 and
  48 kHz, PostFilter, AEC3 decimator) over noise, so kernel and twin can
  agree bit for bit. The reference here is an exact fma in numpy: the
  double sum made exact by TwoSum and rounded to odd, then to float.
- K5's twin gives ``lax.dynamic_slice``'s windows for int32 and int64
  starts alike, negative and past the end, at every start residue mod 4
  (the kernel's 16-byte lines).
- The K2 and K5 wrappers refuse a start that is not an integer tensor and
  a buffer that is not float32, on the CPU path and before the launch.
"""

import jax
import numpy as np
import pytest
import torch

from webrtc_audio_processing_tpu_torch.models import post_filter
from webrtc_audio_processing_tpu_torch.models.aec3 import render_buffer
from webrtc_audio_processing_tpu_torch.ops import (
    biquad,
    cuda_biquad,
    cuda_span,
    cuda_window,
)


def exact_fma(a, b, c):
    """float32(a * b + c) with one rounding, for float32 a, b, c: the
    product is exact in double; TwoSum gives the double sum's error; the
    sum is rounded to odd (moved one ulp toward the error where it is
    inexact and even), which 53 >= 24 + 2 bits make safe to round to
    float32 once more."""
    p = np.float64(a) * np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(np.int64) & 1) == 0
    toward = np.where(err > 0, np.inf, -np.inf)
    s = np.where((err != 0) & even, np.nextafter(s, toward), s)
    return s.astype(np.float32)


def test_exact_fma_sees_a_double_rounding():
    """A sum whose double rounding lands on a float32 tie: the twin's form
    rounds it to even (1.0), the single rounding up (1 + 2**-23)."""
    a = np.float32((2 ** 23 + 2896) * 2.0 ** -23)
    b = np.float32((2 ** 23 - 2895) * 2.0 ** -47)
    c = np.float32(1.0)
    twin = cuda_biquad._fused(float(a), torch.tensor([b]), torch.tensor([c]))
    assert twin.item() == 1.0
    assert exact_fma(a, [b], [c])[0] == np.float32(1 + 2.0 ** -23)


def _tables():
    aa, nr = render_buffer.decimator_coeffs()
    tables = {f"hpf_{rate}": biquad.pack_coeffs(*biquad.HPF_COEFFS[rate])
              for rate in (16000, 32000, 48000)}
    tables["post_filter"] = biquad.pack_coeffs(post_filter.COEFFS_B_48K,
                                               post_filter.COEFFS_A_48K)
    tables["decimator"] = np.concatenate([aa, nr])
    return tables


@pytest.mark.parametrize("table", sorted(_tables()))
def test_twin_fma_is_single_rounding_on_every_table(table, monkeypatch):
    """Every multiply-add of the twin over 64 lanes x 480 samples of noise
    (std 3000, state std 1000) equals the exact fma bit for bit."""
    coeffs = torch.from_numpy(_tables()[table])
    K = coeffs.shape[0]
    rng = np.random.default_rng(K * 1000 + len(table))
    x = torch.from_numpy((rng.standard_normal((480, 64)) * 3000).astype(
        np.float32))
    st = torch.from_numpy((rng.standard_normal((4 * K, 64)) * 1000).astype(
        np.float32))
    fused = cuda_biquad._fused
    checked, differ = [0], [0]

    def checking(a, b, c):
        got = fused(a, b, c)
        want = exact_fma(np.float32(a), b.numpy(), c.numpy())
        differ[0] += int((got.numpy().view(np.int32)
                          != want.view(np.int32)).sum())
        checked[0] += got.numel()
        return got

    monkeypatch.setattr(cuda_biquad, "_fused", checking)
    cuda_biquad.cascade(coeffs, st, x)
    # b0 == 1 or b2 == 1 drops one fused op of a section (module docstring).
    assert checked[0] >= 480 * 64 * K * 2
    assert differ[0] == 0, f"{differ[0]} of {checked[0]} multiply-adds"


def _k5_starts(L, W):
    """Every residue mod 4 in range, negative, past L - W and below -L."""
    starts = []
    for r in range(4):
        starts += [4 * 7 + r, 4 * 90 + r, -(4 * 5 + r), -(L - 4 * 2 - r),
                   L - W + 1 + r, 4 * 500 + r, -(L + 4 * 3 + r)]
    return np.array(starts)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_k5_twin_matches_dynamic_slice_for_int32_and_int64(dtype):
    L, W = 864, 480
    start = _k5_starts(L, W).astype(dtype)
    buf = np.random.default_rng(4).standard_normal(
        (start.size, L)).astype(np.float32)
    want = jax.jit(jax.vmap(
        lambda b, s: jax.lax.dynamic_slice(b, (s,), (W,))))(
            buf, start.astype(np.int32))
    got = cuda_window.take_windows(torch.from_numpy(buf),
                                   torch.from_numpy(start), W)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert {int(s) % 4 for s in start} == {0, 1, 2, 3}


@pytest.mark.parametrize("take", ["cpu", "cuda_wrapper"])
def test_window_and_span_wrappers_refuse_other_dtypes(take):
    """The CPU path checks before the twin; the CUDA wrapper checks before
    it touches the kernel library."""
    k5 = {"cpu": cuda_window.take_windows,
          "cuda_wrapper": cuda_window.take_windows_cuda}[take]
    k2 = {"cpu": cuda_span.span_gather,
          "cuda_wrapper": cuda_span.span_gather_cuda}[take]
    buf, ring = torch.zeros(4, 864), torch.zeros(4, 20, 6)
    ints = torch.zeros(4, dtype=torch.int64)
    for start in (torch.zeros(4), torch.zeros(4, dtype=torch.float64),
                  torch.zeros(4, dtype=torch.bool)):
        with pytest.raises(TypeError, match="start"):
            k5(buf, start, 480)
        with pytest.raises(TypeError, match="start"):
            k2(ring, start, 3)
    for dtype in (torch.float64, torch.float16, torch.int32):
        with pytest.raises(TypeError, match="buf"):
            k5(buf.to(dtype), ints, 480)
        with pytest.raises(TypeError, match="ring"):
            k2(ring.to(dtype), ints, 3)
