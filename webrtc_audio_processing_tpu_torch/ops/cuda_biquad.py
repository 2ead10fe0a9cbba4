"""K1: batched cascaded-biquad (DF1) filtering, a hand-written CUDA kernel.

Replaces ``webrtc_audio_processing_tpu/ops/pallas_biquad.py``
``_biquad_kernel`` (launched by ``_cascade_batched``, vmap rule in
``make_cascade``). Its oracle is ``make_cascade.scan_impl`` as XLA:CPU
compiles it: ``x * 1.0`` folded away and each multiply-add contracted into
a fused multiply-add (read off XLA's LLVM IR for the HPF tables and
checked bit for bit against the jitted JAX scan):

    acc = b0 == 1 ? fma(b1, x1, x) : fma(b0, x, b1*x1)
    acc = b2 == 1 ? x2 + acc       : fma(b2, x2, acc)
    acc = fma(-a1, y1, acc)
    acc = fma(-a2, y2, acc)

The kernel evaluates each fma as one float32 FFMA, XLA:CPU's own single
rounding. The twin evaluates it as the float rounding of the exact double
product plus c; on every multiply-add of the port's tables the two agree
(tests/test_torch_kernel_contracts.py holds ``_fused`` to an exact fma),
so kernel and twin agree bit for bit.

What bounds it on an H100: one read and one write of the (T, M) frame and
the state (16.1 MB at the HPF's T = 480, M = 4096: 0.0048 ms), while the
recurrence's own chain is only ~2T + 4K dependent multiply-adds (0.002
ms): y_t depends on y_{t-1} through the last two of a section's four. The
kernel (``csrc/biquad.cu``) keeps one thread per lane with the sections in
registers and runs the sections skewed by one sample each, so the K
updates of a step are independent and each sample waits on 2 FFMAs, not
on 4K; one-warp blocks spread the lanes over 128 of the 132 SMs at
M = 4096; the input arrives through shared memory in cp.async chunks,
double-buffered, so loads overlap the filtering.

Layout: ``x_t`` and ``y_t`` are (T, M) time-major, ``state`` is (4K, M)
with rows [x1, x2, y1, y2] per section, ``coeffs`` is (K, 5) float32 rows
[b0, b1, b2, a1, a2].

Dispatch: a CUDA tensor launches the kernel (or raises); only a CPU tensor
runs the plain twin.
"""

from __future__ import annotations

import torch

from webrtc_audio_processing_tpu_torch.ops import cuda_build

MAX_SECTIONS = 4

# Kernel launches since the last reset; only the CUDA branch counts.
launches = 0


def _fused(a: float, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fma(a, b, c) for float32 values: the product is exact in double, the
    sum is rounded to double and then to float."""
    return (b.double() * a + c.double()).float()


def cascade_plain(coeffs: torch.Tensor, state: torch.Tensor,
                  x_t: torch.Tensor):
    """Plain PyTorch twin: the per-sample loop of scan_impl in the
    oracle's contracted rounding (module docstring), one eager op at a
    time."""
    c = coeffs.detach().to("cpu", torch.float32).tolist()
    K = len(c)
    x1 = [state[4 * k + 0] for k in range(K)]
    x2 = [state[4 * k + 1] for k in range(K)]
    y1 = [state[4 * k + 2] for k in range(K)]
    y2 = [state[4 * k + 3] for k in range(K)]
    out = []
    for t in range(x_t.shape[0]):
        sig = x_t[t]
        for k, (b0, b1, b2, a1, a2) in enumerate(c):
            if b0 == 1.0:
                y = _fused(b1, x1[k], sig)
            else:
                y = _fused(b0, sig, b1 * x1[k])
            y = x2[k] + y if b2 == 1.0 else _fused(b2, x2[k], y)
            y = _fused(-a1, y1[k], y)
            y = _fused(-a2, y2[k], y)
            x2[k] = x1[k]
            x1[k] = sig
            y2[k] = y1[k]
            y1[k] = y
            sig = y
        out.append(sig)
    rows = []
    for k in range(K):
        rows += [x1[k], x2[k], y1[k], y2[k]]
    return torch.stack(rows), torch.stack(out)


def _check(coeffs, state, x_t):
    if coeffs.dim() != 2 or coeffs.shape[1] != 5:
        raise ValueError(f"coeffs must be (K, 5), got {tuple(coeffs.shape)}")
    K = coeffs.shape[0]
    if not 1 <= K <= MAX_SECTIONS:
        raise ValueError(f"1..{MAX_SECTIONS} sections supported, got {K}")
    if x_t.dim() != 2:
        raise ValueError(f"x_t must be (T, M), got {tuple(x_t.shape)}")
    if tuple(state.shape) != (4 * K, x_t.shape[1]):
        raise ValueError(
            f"state must be ({4 * K}, {x_t.shape[1]}), got "
            f"{tuple(state.shape)}"
        )
    for name, t in (("coeffs", coeffs), ("state", state), ("x_t", x_t)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != x_t.device:
            raise ValueError(f"{name} is on {t.device}, x_t on {x_t.device}")


def cascade_cuda(coeffs: torch.Tensor, state: torch.Tensor,
                 x_t: torch.Tensor):
    """Launch the kernel on PyTorch's current stream."""
    global launches
    _check(coeffs, state, x_t)
    coeffs, state, x_t = (t if t.is_contiguous() else t.contiguous()
                          for t in (coeffs, state, x_t))
    T, M = x_t.shape
    y_t = torch.empty_like(x_t)
    st_out = torch.empty_like(state)
    err = cuda_build.library().lib.biquad_cascade_f32(
        x_t.data_ptr(), y_t.data_ptr(), state.data_ptr(), st_out.data_ptr(),
        coeffs.data_ptr(), coeffs.shape[0], T, M, cuda_build.raw_stream(x_t),
    )
    cuda_build.check(err, "biquad_cascade_f32")
    launches += 1
    return st_out, y_t


def cascade(coeffs: torch.Tensor, state: torch.Tensor, x_t: torch.Tensor):
    """(coeffs (K, 5), state (4K, M), x_t (T, M)) -> (state, y_t)."""
    if x_t.is_cuda:
        return cascade_cuda(coeffs, state, x_t)
    if x_t.is_cpu:
        _check(coeffs, state, x_t)
        return cascade_plain(coeffs, state, x_t)
    raise ValueError(f"unsupported device {x_t.device}")
