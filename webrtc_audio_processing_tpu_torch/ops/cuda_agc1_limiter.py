"""AGC1's overload limiter, a hand-written CUDA kernel.

    for k in 1..10: while overloaded(gains[:, k], env[:, k-1]):
                        gains[:, k] -= 0.1 dB          (x 253 / 256)
    gains[:, k] = min(gains[:, k:11])  for k in 1..9   (1 ms earlier)

The loop of ``webrtc_audio_processing_tpu/models/agc1/digital.py:397-427``
(reference: digital_agc.cc:439-483), which the JAX package runs as a
``lax.while_loop`` under ``vmap``, not in Pallas: a port-only kernel. Its
length depends on the data, and plain PyTorch has no form of it that a
CUDA graph can capture (``while mask.any()`` reads the device each pass;
a masked loop run to the worst case adds that many graph nodes), so on the
card it runs in ``csrc/agc1_limiter.cu``, one thread per (row, subframe),
stopping where the reference stops, and the backward minimum follows in
the same launch. int32 in, int32 out, bit-equal to the JAX loop.

The worst case over AGC1's whole configuration range:
``tools/torch_agc1_limiter_worst.py`` counts the passes of every gain of
every table on envelopes up to full scale (727, PERF.md §6).

What bounds it on an H100: it is latency-bound. It reads 11 + 10 and
writes 11 int32 a row (0.52 MB at 4096 rows: 0.16 us at 3.35 TB/s), while
a row that needs the loop waits on a chain of dependent passes of ~20
integer ops each; most rows of real audio need none.

Dispatch: a CUDA tensor launches the kernel (or raises); only a CPU tensor
runs the plain twin.
"""

from __future__ import annotations

import torch

from webrtc_audio_processing_tpu_torch.ops import cuda_build, spl

# Kernel launches since the last reset; only the CUDA branch counts.
launches = 0

I32 = torch.int32


def _overloaded(g: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """The loop condition (digital_agc.cc:449-462)."""
    zeros = torch.where(g > 47452159, 16 - spl.norm_w32(g), 10).to(I32)
    gain32 = (g >> zeros) + 1
    gain32 = gain32 * gain32
    lhs = spl.agc_mul32((e >> 12) + 1, gain32)
    shift = 2 * (1 - zeros + 10)
    rhs = torch.where(shift >= 0, 32767 << torch.clamp(shift, min=0),
                      32767 >> torch.clamp(-shift, min=0))
    return lhs > rhs


def _step_down(g: torch.Tensor) -> torch.Tensor:
    return torch.where(g > 8388607, (g // 256) * 253, (g * 253) // 256)


def _loop(g: torch.Tensor, env: torch.Tensor):
    """The loop with a ``while`` on the host: (limited gains, passes per
    element)."""
    n = torch.zeros_like(g)
    while True:
        over = _overloaded(g, env)
        if not bool(over.any()):
            return g, n
        g = torch.where(over, _step_down(g), g)
        n = n + over.to(I32)


def limit_plain(gains: torch.Tensor, env: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin: the loop, then the backward minimum."""
    g, _ = _loop(gains[:, 1:], env)
    g = torch.flip(torch.cummin(torch.flip(g, [1]), 1).values, [1])
    return torch.cat([gains[:, :1], g], 1).to(I32)


def passes(gains: torch.Tensor, env: torch.Tensor) -> torch.Tensor:
    """The loop's passes for each subframe of (gains (N, 11), env (N, 10)):
    (N, 10) int32, the work the data needs (the kernel's bound)."""
    return _loop(gains[:, 1:], env)[1]


def _check(gains, env):
    if gains.dim() != 2 or gains.shape[1] != 11:
        raise ValueError(f"gains must be (N, 11), got {tuple(gains.shape)}")
    if tuple(env.shape) != (gains.shape[0], 10):
        raise ValueError(f"env must be ({gains.shape[0]}, 10), got "
                         f"{tuple(env.shape)}")
    for name, t in (("gains", gains), ("env", env)):
        if t.dtype != I32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if env.device != gains.device:
        raise ValueError(f"env is on {env.device}, gains on {gains.device}")


def limit_cuda(gains: torch.Tensor, env: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on PyTorch's current stream."""
    global launches
    _check(gains, env)
    cuda_build.check_current_device(gains)
    gains = gains.contiguous()
    env = env.contiguous()
    out = torch.empty_like(gains)
    err = cuda_build.library().lib.agc1_limiter_i32(
        gains.data_ptr(), env.data_ptr(), out.data_ptr(), gains.shape[0],
        cuda_build.raw_stream(gains))
    cuda_build.check(err, "agc1_limiter_i32")
    launches += 1
    return out


def limit(gains: torch.Tensor, env: torch.Tensor) -> torch.Tensor:
    """(gains (N, 11), env (N, 10)) int32 -> limited gains (N, 11)."""
    if gains.is_cuda:
        return limit_cuda(gains, env)
    if gains.is_cpu:
        _check(gains, env)
        return limit_plain(gains, env)
    raise ValueError(f"unsupported device {gains.device}")
