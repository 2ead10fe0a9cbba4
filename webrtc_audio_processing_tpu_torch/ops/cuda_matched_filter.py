"""K3: the AEC3 matched-filter NLMS bank, a hand-written CUDA kernel.

Replaces ``webrtc_audio_processing_tpu/ops/pallas_mf.py`` ``_mf_kernel``
and ``_mf_t_kernel`` (launched by ``matched_filter_nlms`` and
``matched_filter_nlms_t``, chosen by the vmap rule of ``make_nlms``), which
compute the same function in two TPU layouts. Its oracle is
``_nlms_scan`` (``pallas_mf.py:526-559``): for each of N staggered filters,
a per-sample NLMS over the decimated capture sub-block against sliding
windows of the wrap-extended low-rate render ring, gated by the x^2
threshold and capture saturation (|y| >= 32000). See ``csrc/
matched_filter.cu`` for the formulas.

What bounds it on an H100: per launch it reads the ring span that the
segments touch and the filters and writes the filters and the segments
(81 MB at B = 2048, N = 5, about 24 us at the card's bandwidth); its
arithmetic (0.5 GFLOP) and its chain of 16 dependent NLMS steps are far
below that. The kernel runs one warp per (stream, filter) with no block
barrier: each lane holds taps / 32 consecutive taps and the segment values
they touch in registers, each step reduces its two dot products in one
transposed butterfly (6 shuffles), and every lane computes the step's gate
and alpha itself. The segment and the filter pass through a padded
shared-memory slice per warp, so every global read and write is coalesced;
the overlap of a stream's five segments is left to L2 (staging it once per
block measured slower). It is specialised for taps 512, sub 16, with a
runtime-sub form for the rest of the domain. Sums are taken per lane as an
FMA chain, then as a pairwise tree over the lanes, another order than the
twin's, so they agree to float rounding: the tests hold h, alphas and err
within 2e-5 of the largest value and ``updated`` and ``segs`` exactly
(``tests/test_pallas_mf_kernel.py``'s bar), and
``tests/test_torch_kernel_contracts.py`` holds a model of the kernel's
order to ``_nlms_scan`` at the same bar.

Dispatch: a CUDA tensor launches the kernel (or raises); only a CPU tensor
runs the plain twin.
"""

from __future__ import annotations

import torch

from webrtc_audio_processing_tpu_torch.ops import cuda_build

# Kernel launches since the last reset; only the CUDA branch counts.
launches = 0


def nlms_plain(lowrate, lr_read, h0, y, smoothing, *, shift: int,
               ds_size: int, threshold: float):
    """Plain PyTorch twin of ``_nlms_scan``, batched over streams.

    lowrate (B, DS), lr_read (B,), h0 (B, N, taps), y (B, sub), smoothing
    (B,) -> (h, alphas (B, N, sub), err (B, N), updated (B, N) bool, segs
    (B, N, sub - 1 + taps))."""
    B, N, taps = h0.shape
    sub = y.shape[1]
    seg_len = sub - 1 + taps
    dev = lowrate.device
    ring2 = torch.cat([lowrate, lowrate[:, :seg_len]], dim=1)
    starts = torch.remainder(
        lr_read.to(torch.int64)[:, None]
        + torch.arange(N, device=dev) * shift, ds_size)
    idx = starts[..., None] + torch.arange(seg_len, device=dev)
    segs = torch.gather(ring2[:, None, :].expand(B, N, ring2.shape[1]), 2,
                        idx)
    xw = torch.stack(
        [segs[..., sub - 1 - i: sub - 1 - i + taps] for i in range(sub)],
        dim=2)  # (B, N, sub, taps)
    x2 = torch.sum(xw * xw, dim=-1)
    sat = (y >= 32000.0) | (y <= -32000.0)
    gate = (x2 > threshold) & ~sat[:, None, :]
    h = h0
    err = torch.zeros((B, N), dtype=h0.dtype, device=dev)
    alphas = []
    for i in range(sub):
        x_i = xw[:, :, i]
        s_i = torch.sum(h * x_i, dim=-1)
        e_i = y[:, i: i + 1] - s_i
        a_i = torch.where(
            gate[:, :, i],
            smoothing[:, None] * e_i / torch.clamp(x2[:, :, i], min=1e-30),
            0.0)
        h = h + a_i[..., None] * x_i
        err = err + e_i * e_i
        alphas.append(a_i)
    return h, torch.stack(alphas, dim=-1), err, gate.any(dim=-1), segs


def _check(lowrate, lr_read, h0, y, smoothing):
    B = lowrate.shape[0]
    if (lowrate.dim() != 2 or h0.dim() != 3 or h0.shape[0] != B
            or y.dim() != 2 or y.shape[0] != B or lr_read.shape != (B,)
            or smoothing.shape != (B,)):
        raise ValueError(
            f"need lowrate (B, DS), lr_read (B,), h0 (B, N, taps), y (B, "
            f"sub), smoothing (B,); got {tuple(lowrate.shape)}, "
            f"{tuple(lr_read.shape)}, {tuple(h0.shape)}, {tuple(y.shape)}, "
            f"{tuple(smoothing.shape)}")
    for name, t in (("lowrate", lowrate), ("h0", h0), ("y", y),
                    ("smoothing", smoothing)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if lr_read.dtype != torch.int32:
        raise TypeError(f"lr_read must be int32, got {lr_read.dtype}")
    for t in (lr_read, h0, y, smoothing):
        if t.device != lowrate.device:
            raise ValueError(f"inputs on {t.device} and {lowrate.device}")


def nlms_cuda(lowrate, lr_read, h0, y, smoothing, *, shift: int,
              ds_size: int, threshold: float):
    """Launch the kernel on PyTorch's current stream."""
    global launches
    _check(lowrate, lr_read, h0, y, smoothing)
    lib = cuda_build.library().lib
    lowrate, lr_read, h0, y, smoothing = (
        t.contiguous() for t in (lowrate, lr_read, h0, y, smoothing))
    B, N, taps = h0.shape
    sub = y.shape[1]
    dev = lowrate.device
    h = torch.empty_like(h0)
    alphas = torch.empty((B, N, sub), dtype=torch.float32, device=dev)
    err = torch.empty((B, N), dtype=torch.float32, device=dev)
    updated = torch.empty((B, N), dtype=torch.bool, device=dev)
    segs = torch.empty((B, N, sub - 1 + taps), dtype=torch.float32,
                       device=dev)
    stream = cuda_build.raw_stream(lowrate)
    rc = lib.matched_filter_nlms_f32(
        lowrate.data_ptr(), lr_read.data_ptr(), h0.data_ptr(), y.data_ptr(),
        smoothing.data_ptr(), h.data_ptr(), alphas.data_ptr(),
        err.data_ptr(), updated.data_ptr(), segs.data_ptr(), B, N, shift,
        ds_size, float(threshold), sub, taps, stream)
    cuda_build.check(rc, "matched_filter_nlms_f32")
    launches += 1
    return h, alphas, err, updated, segs


def nlms(lowrate, lr_read, h0, y, smoothing, *, shift: int, ds_size: int,
         threshold: float):
    """The NLMS bank; see ``nlms_plain`` for shapes."""
    kw = dict(shift=shift, ds_size=ds_size, threshold=threshold)
    if lowrate.device.type == "cuda":
        return nlms_cuda(lowrate, lr_read, h0, y, smoothing, **kw)
    if lowrate.device.type == "cpu":
        _check(lowrate, lr_read, h0, y, smoothing)
        return nlms_plain(lowrate, lr_read, h0, y, smoothing, **kw)
    raise ValueError(f"unsupported device {lowrate.device}")
