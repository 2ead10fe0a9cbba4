"""K4: the matched filter's pre-echo errors, a hand-written CUDA kernel.

Replaces ``webrtc_audio_processing_tpu/ops/pallas_pre_echo.py`` ``_kernel``
and ``_t_kernel`` (launched by ``_pre_echo_tpu`` and ``_pre_echo_tpu_t``,
chosen by ``make_pre_echo``). Its oracle is ``pre_echo_inst_xla``
(``pallas_pre_echo.py:35-56``): for the winning filter, with
h_i = h0 + sum_{j<i} a_j x_j, the squared error between y_i and each
4-tap-chunk prefix of h_i . x_i, summed over the 16 steps: 128 errors per
stream. See ``csrc/pre_echo.cu``.

What bounds it on an H100: it reads about 4.8 KB per stream (10 MB at
B = 2048, about 3 us at the card's bandwidth); its 16 steps depend on each
other only through one FMA per tap (the wex chain), so the bytes bound it.
The kernel runs one warp per stream, four streams per block sharing
nothing, and no block barrier: each lane holds 16 consecutive taps (4
chunks) of h0, wex and the segment in registers, and each step takes the
chunk sums and their prefix in the lane, then one warp scan of the lane
totals. Specialised for taps 512, acc_rate 4, sub 16, with a general form
(the same order, its state in shared memory) for the rest of the domain.
Sums are taken in another order than the twin's: the tests hold it within
2e-4 after dividing by max(|out|, 1) (``tests/test_pallas_pre_echo.py``'s
bar), and ``tests/test_torch_kernel_contracts.py`` holds a model of the
kernel's order to ``pre_echo_inst_xla`` at the same bar. Fusing it into
K3 is open (ROADMAP Queue 2 item 3).

Dispatch: a CUDA tensor launches the kernel (or raises); only a CPU tensor
runs the plain twin.
"""

from __future__ import annotations

import torch

from webrtc_audio_processing_tpu_torch.ops import cuda_build

# Kernel launches since the last reset; only the CUDA branch counts.
launches = 0


def pre_echo_plain(seg, h0, alphas, y, acc_rate: int):
    """Plain PyTorch twin of ``pre_echo_inst_xla``, batched over streams:
    seg (B, sub - 1 + taps), h0 (B, taps), alphas (B, sub), y (B, sub) ->
    (B, taps // acc_rate)."""
    B, taps = h0.shape
    sub = y.shape[1]
    chunks = taps // acc_rate
    wex = torch.zeros_like(h0)
    acc = torch.zeros((B, chunks), dtype=h0.dtype, device=h0.device)
    for i in range(sub):
        x_i = seg[:, sub - 1 - i: sub - 1 - i + taps]
        p = (h0 + wex) * x_i
        part = torch.cumsum(p.reshape(B, chunks, acc_rate).sum(-1), dim=1)
        acc = acc + (y[:, i: i + 1] - part) ** 2
        wex = wex + alphas[:, i: i + 1] * x_i
    return acc


def _check(seg, h0, alphas, y, acc_rate):
    B, taps = h0.shape
    sub = y.shape[1]
    if (seg.shape != (B, sub - 1 + taps) or alphas.shape != (B, sub)
            or y.shape != (B, sub) or taps % acc_rate):
        raise ValueError(
            f"need seg (B, sub-1+taps), h0 (B, taps), alphas and y (B, sub);"
            f" got {tuple(seg.shape)}, {tuple(h0.shape)}, "
            f"{tuple(alphas.shape)}, {tuple(y.shape)}")
    for name, t in (("seg", seg), ("h0", h0), ("alphas", alphas), ("y", y)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != h0.device:
            raise ValueError(f"{name} is on {t.device}, h0 on {h0.device}")


def pre_echo_cuda(seg, h0, alphas, y, acc_rate: int):
    """Launch the kernel on PyTorch's current stream."""
    global launches
    _check(seg, h0, alphas, y, acc_rate)
    cuda_build.check_current_device(h0)
    lib = cuda_build.library().lib
    seg, h0, alphas, y = (t.contiguous() for t in (seg, h0, alphas, y))
    B, taps = h0.shape
    out = torch.empty((B, taps // acc_rate), dtype=torch.float32,
                      device=h0.device)
    stream = cuda_build.raw_stream(h0)
    rc = lib.pre_echo_inst_f32(seg.data_ptr(), h0.data_ptr(),
                               alphas.data_ptr(), y.data_ptr(),
                               out.data_ptr(), B, y.shape[1], taps, acc_rate,
                               stream)
    cuda_build.check(rc, "pre_echo_inst_f32")
    launches += 1
    return out


def pre_echo_inst(seg, h0, alphas, y, acc_rate: int):
    """(B, taps // acc_rate) instantaneous pre-echo errors."""
    if h0.device.type == "cuda":
        return pre_echo_cuda(seg, h0, alphas, y, acc_rate)
    if h0.device.type == "cpu":
        _check(seg, h0, alphas, y, acc_rate)
        return pre_echo_plain(seg, h0, alphas, y, acc_rate)
    raise ValueError(f"unsupported device {h0.device}")
