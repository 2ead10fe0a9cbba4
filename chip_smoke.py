"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its result; any failed check raises and the script
exits non-zero without a result line:

1. device: the card's name and power limit; TF32 off.
2. build: the CUDA kernels built from ``webrtc_audio_processing_tpu_torch/
   csrc`` with nvcc (sm_90a, one nvcc per source, all at once) and loaded
   with ctypes.
3. kernels: K1 (biquad cascade, at the HPF's, the AEC3 decimators' and the
   PostFilter's shapes), K2 (ring span read), K3 (matched-filter NLMS bank;
   the specialised form at the path's taps 512, sub 16, the general form at
   taps 256, sub 8), K4 (pre-echo errors; taps 512, acc_rate 4, and the
   general form at taps 256, acc_rate 8), K5 (window read) and K6 (the
   subtractor pair kernel, at 48 kHz stereo for 2 and 3 blocks with and
   without events, and at 16 kHz mono; both geometries also with render
   spectra below the gains' noise gate; 48 kHz stereo also with window
   starts that jump to the second chain or clamp at either end of it, the
   twin given the clamped starts) against their plain PyTorch twins on
   the card at the main paths' shapes. Each row gives the call time (CUDA
   events around back-to-back calls from Python: what a caller pays, host
   work included), the device time (the calls captured in a CUDA graph and
   replayed: the kernel alone), the device kernels one call runs, the twin's
   call time and, for K2 and K5, the same two times of the one PyTorch call
   that computes the same function (``torch.gather`` on a prebuilt index).
4. Three AEC3 paths through ``apm.process_stream_pair`` with HPF, AEC3, NS
   and AGC2 (the bench's configurations, bench.py:30-78), each 300 frames
   (3 s) of an echo scene with the last 100 frames timed:
   - ``aec3_path``: B = 2048 streams of 48 kHz stereo, the plain
     subtractor (the default);
   - ``pair_kernel_48k``: the same with the subtractor on K6;
   - ``pair_kernel_16k_mono``: B = 4096 streams of 16 kHz mono on K6.
   Every kernel must launch the number of times the code implies (K6 once
   per frame on the pair-kernel paths, never on the plain one), and the
   echo must be cancelled (ERLE over the last third above 6 dB,
   tests/test_apm_48k_stereo.py's bar). Three profiled frames count the
   device kernels per frame (the first is the profiler's warm-up).
5. After each path, its cross-check: two streams rerun on the CPU by the
   same port (plain twins) from the card's state before each checked frame
   (every third or fourth frame from 76 to 195, the untimed run after the
   delay has locked): relative RMS <= 1e-3 and the same delay on every
   checked frame. A free-running rerun over the first 20 of those frames
   is printed beside it: AEC3 turns float noise into
   decisions (the refined filter's leakage choice when the refined and
   coarse error energies tie to a few ulps), so two devices drift apart
   within tens of frames with the same ERLE (tools/torch_card_vs_cpu.py
   finds the first diverging leaf).
6. slice-1 path (echo canceller off): 30 timed frames, one K1 and one K5
   launch per frame, and its cross-check on 4 streams.
7. After each AEC3 path's cross-check, the same path graphed: the frame
   pair step (``step_graph.PairGraph``: two ``Apm.forward`` calls, AEC3's
   block ordinal on the device) captured as one CUDA graph from
   ``init_state`` and replayed 150 times over the same scene. The captured
   launches per pair must be phase 4's for two frames, the checked
   streams' outputs and delays on every frame bit-equal to phase 4's eager
   run (the graph replays the same kernels in the same order), ERLE above
   6 dB. It prints ms per frame over the last 100 frames (host clock and
   CUDA events), real-time streams, the capture's seconds, device kernels
   per frame (torch.profiler over two replays after a warm-up replay), the
   peak device memory and the memory the graph's pool holds.
8. The bench twin (``webrtc_audio_processing_tpu_torch/bench.py``) at one
   batch a mode, B = 2048 at 48 kHz stereo and B = 4096 at 16 kHz mono,
   with the subtractor ``AEC3_PAIR_KERNEL`` selects: the line the twin
   prints for those batches.

Before the last line the kernel table as JSON, then the result JSON. The
script imports no JAX.

    python3 chip_smoke.py --kernels-only

runs phases 1-3 alone and prints no result line.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

B = 2048
SEED = 20261016
RTOL_RMS = 1e-3  # BASELINE.md deviation bar, per stream
PROB_ATOL = 1e-3
ERLE_BAR_DB = 6.0  # tests/test_apm_48k_stereo.py:56

AEC3_FRAMES = 300
AEC3_TIMED = 100
PROFILED_FRAMES = 3  # the first is the profiler's warm-up
FREE_FRAMES = 20

# K6 against its twin: 2e-3 of each float leaf's scale
# (tests/test_subtractor_pallas.py:119-124), integer leaves exact.
K6_RTOL = 2e-3
# Ties. Below the gains' noise gate no filter adapts: after a coarse reset
# the refined and coarse filters differ by a transform round trip, and
# e2_refined and e2_coarse can lie within a few ulps, so rounding (which
# kernel and twin do in another order) decides `e2_refined < e2_coarse`.
# A stream on which the two decide it differently, with both gaps within
# K6_TIE_ULPS float32 ulps of the larger energy, took the other branch of a
# tie: its integer leaves may differ (the poor-coarse counter), and where
# the tie decided a coarse reset (its hangover differs) its float leaves
# too. Such reset splits may be at most K6_MAX_RESET_SPLITS of the streams;
# every other stream is held to K6_RTOL and exact integers.
K6_TIE_ULPS = 4
K6_MAX_RESET_SPLITS = 0.01
# name: (streams, capture channels, render channels, blocks, events,
# render spectra below the noise gate, window starts that jump chains or
# clamp)
K6_CASES = {
    "48k_stereo_nb3": (B, 2, 2, 3, False, False, False),
    "48k_stereo_nb3_events": (B, 2, 2, 3, True, False, False),
    "48k_stereo_nb2": (B, 2, 2, 2, False, False, False),
    "48k_stereo_nb2_events": (B, 2, 2, 2, True, False, False),
    "48k_stereo_nb3_below_gate": (B, 2, 2, 3, False, True, False),
    "16k_mono_nb3": (4096, 1, 1, 3, False, False, False),
    "16k_mono_nb3_below_gate": (4096, 1, 1, 3, False, True, False),
    "48k_stereo_nb3_jumps": (B, 2, 2, 3, False, False, True),
}


@dataclasses.dataclass(frozen=True)
class Aec3Path:
    """One AEC3 path of phase 4: the bench mode (``BENCH_MODES``), the
    streams, the subtractor, the two streams checked on the CPU and the
    frames of the cross-check."""

    name: str
    mode: str
    batch: int
    pair_kernel: bool
    check: tuple
    cross: range


# The cross-checks run on one CPU core (~0.7 s a frame at 48 kHz): 40 and
# 30 frames keep the script near half its 1200 s limit on a slow host. They
# are spread over frames 76-195, before the profiled and timed frames.
AEC3_PATHS = (
    Aec3Path("aec3_path", "48k_stereo", B, False, (0, B - 1),
             range(76, 196, 3)),
    Aec3Path("pair_kernel_48k", "48k_stereo", B, True, (0, B - 1),
             range(76, 196, 4)),
    Aec3Path("pair_kernel_16k_mono", "16k_mono", 4096, True, (0, 4095),
             range(76, 196, 4)),
)

SLICE_WARMUP = 10
SLICE_TIMED = 30
SLICE_CHECK = (0, 683, 1366, 2047)

# The card's peaks for the bounds: HBM bandwidth and float32 rate outside
# the tensor cores (NVIDIA's H100 SXM data sheet). A dependent chain (K1's
# recurrence, K3's and K4's steps) is bounded by its dependent-instruction
# latency: 4 cycles per dependent operation at the 1,980 MHz boost clock.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
DEP_OP_S = 4 / 1.98e9


def phase(kind, **fields):
    print(json.dumps({"phase": kind, **fields}), flush=True)


def device_phase():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    phase("device", name=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), nvidia_smi=smi,
          torch=torch.__version__, cuda=torch.version.cuda)
    return smi


def build_phase():
    from webrtc_audio_processing_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    lib = cuda_build.library()
    phase("build", seconds=round(time.perf_counter() - t0, 3),
          nvcc_seconds=round(lib.build_seconds, 3), library=lib.path.name,
          ptxas=cuda_build.ptxas_lines(lib.log))


def _event_ms(fn, n, rounds=5):
    """Call time: CUDA events around ``n`` back-to-back calls from Python,
    per call, the median of ``rounds`` rounds (the card's host is shared,
    and a round can catch another tenant's burst)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    return float(np.median(times))


def _graph_ms(fn, n, replays=5):
    """Device time per call: ``n`` calls of ``fn`` captured in one CUDA
    graph (after a warm-up outside the capture), the graph replayed
    ``replays`` times between two CUDA events. The Python and dispatch
    cost of each call stays out; the inputs stay in L2 where they fit,
    as on the path, where the producing kernel ran just before."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (n * replays)


def _times(fn, n_call, n_graph):
    """A wrapper's call time, device time and device kernels per call
    (torch.profiler, after a warm-up step: the bench twin's count)."""
    from webrtc_audio_processing_tpu_torch import bench

    return dict(ms=_event_ms(fn, n_call), device_ms=_graph_ms(fn, n_graph),
                device_kernels_per_call=bench.device_kernels([fn] * 5,
                                                             [fn] * 5))


def _bound_ms(n_bytes, n_ops=0.0, chain_s=0.0):
    """The least time for the work: the larger of the bytes over HBM
    bandwidth and the operations over the float32 rate (or a dependent
    chain's latency)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = max(n_ops / FP32_FLOPS, chain_s)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _max_rel(got, want):
    want = want.double()
    return float((got.double() - want).abs().max()
                 / (want.abs().max() + 1e-30))


def _k1_case(dev, rng, coeffs_np, T, M):
    from webrtc_audio_processing_tpu_torch.ops import cuda_biquad

    K = coeffs_np.shape[0]
    coeffs = torch.from_numpy(coeffs_np).to(dev)
    x_t = torch.from_numpy(
        (rng.standard_normal((T, M)) * 3000).astype(np.float32)).to(dev)
    st = torch.from_numpy(
        (rng.standard_normal((4 * K, M)) * 1000).astype(np.float32)).to(dev)
    st_k, y_k = cuda_biquad.cascade_cuda(coeffs, st, x_t)
    st_p, y_p = cuda_biquad.cascade_plain(coeffs, st, x_t)
    torch.cuda.synchronize()
    err = max(float((y_k - y_p).abs().max()),
              float((st_k - st_p).abs().max()))
    if not (torch.equal(y_k, y_p) and torch.equal(st_k, st_p)):
        raise AssertionError(f"K1 differs from its twin at K={K}, T={T}, "
                             f"M={M}: max |diff| {err}")
    # The least time of the work, not of one design: one read and one write
    # of the frame and the state, or the recurrence's own chain, whichever
    # is longer. Each output depends on the one before it only through the
    # two feedback multiply-adds (the x-side terms can be computed ahead),
    # and the K sections can run skewed by one sample each, so the chain is
    # 2 dependent multiply-adds per sample plus the 4K of filling the
    # cascade once.
    bound, by = _bound_ms((2 * T * M + 8 * K * M) * 4,
                          chain_s=(2 * T + 4 * K) * DEP_OP_S)
    return dict(
        max_abs_err=err,
        **_times(lambda: cuda_biquad.cascade_cuda(coeffs, st, x_t), 50, 50),
        plain_ms=_event_ms(lambda: cuda_biquad.cascade_plain(coeffs, st,
                                                             x_t), 2),
        bound_ms=bound, bound_by=by, shape=f"K={K} T={T} M={M}",
    )


def _k3_case(dev, rng, taps, sub):
    """K3 against its twin at (taps, sub) on the matched filter's ring,
    timed; returns the row's fields and the inputs K4 reuses."""
    from webrtc_audio_processing_tpu_torch.ops import cuda_matched_filter

    f32, N, DS = np.float32, 5, 2448
    low = torch.from_numpy(
        rng.standard_normal((B, DS)).astype(f32) * 400).to(dev)
    lr = torch.from_numpy(rng.integers(0, DS, B).astype(np.int32)).to(dev)
    h0 = torch.from_numpy(
        rng.standard_normal((B, N, taps)).astype(f32) * 0.01).to(dev)
    y = torch.from_numpy(rng.standard_normal((B, sub)).astype(f32) * 400).to(
        dev)
    sm = torch.full((B,), 0.7, device=dev)
    kw = dict(shift=384, ds_size=DS, threshold=taps * 150.0 ** 2)
    got = cuda_matched_filter.nlms_cuda(low, lr, h0, y, sm, **kw)
    want = cuda_matched_filter.nlms_plain(low, lr, h0, y, sm, **kw)
    torch.cuda.synchronize()
    rel = max(_max_rel(g, w) for g, w in zip(got[:3], want[:3]))
    if rel > 2e-5 or not (torch.equal(got[3], want[3])
                          and torch.equal(got[4], want[4])):
        raise AssertionError(f"K3 differs from its twin at taps={taps}, "
                             f"sub={sub}: max-relative {rel}")
    # Bytes: the ring entries the N segments of a stream touch (starts
    # shift apart, so at most (N - 1) * shift + seg_len of the DS), lr_read,
    # y and smoothing read, the filters read and written, the segments,
    # alphas and err written (float32 and int32), updated (1 byte). The
    # chain: each of the sub steps waits on one multiply and log2(taps)
    # adds of its dot products, e, the max, the division and the gate's
    # select, and the update's multiply-add.
    seg_len = sub - 1 + taps
    ring_read = min(DS, (N - 1) * kw["shift"] + seg_len)
    n_bytes = 4 * (B * ring_read + B * (sub + 2) + 2 * B * N * taps
                   + B * N * (seg_len + sub + 1)) + B * N
    bound, by = _bound_ms(
        n_bytes, n_ops=B * N * sub * taps * 6,
        chain_s=sub * (1 + (taps - 1).bit_length() + 4 + 1) * DEP_OP_S)
    return dict(
        max_abs_err=max(float((g - w).abs().max())
                        for g, w in zip(got[:3], want[:3])),
        max_rel_err=rel,
        **_times(lambda: cuda_matched_filter.nlms_cuda(
            low, lr, h0, y, sm, **kw), 50, 20),
        plain_ms=_event_ms(lambda: cuda_matched_filter.nlms_plain(
            low, lr, h0, y, sm, **kw), 5),
        bound_ms=bound, bound_by=by,
        shape=f"B={B} N={N} taps={taps} sub={sub}"), (low, h0, y, got)


def _k4_case(dev, seg, h0, al, y, rate):
    """K4 against its twin on the given inputs, timed."""
    from webrtc_audio_processing_tpu_torch.ops import cuda_pre_echo

    taps, sub = h0.shape[1], y.shape[1]
    pe_k = cuda_pre_echo.pre_echo_cuda(seg, h0, al, y, rate)
    pe_p = cuda_pre_echo.pre_echo_plain(seg, h0, al, y, rate)
    torch.cuda.synchronize()
    norm = float(((pe_k - pe_p) / torch.clamp(pe_p.abs(), min=1.0)).abs()
                 .max())
    if norm > 2e-4:
        raise AssertionError(f"K4 differs from its twin at taps={taps}, "
                             f"acc_rate={rate}: {norm}")
    # Bytes: seg, h0, y and the sub - 1 alphas that move the filter before
    # a later step (the last one moves it after every step is scored) read,
    # the errors written. The chain: the sub-step wex chain (one
    # multiply-add per step), then the last step's add and product, its
    # chunk sums and prefix (log2(taps) adds), d and the multiply-add into
    # acc.
    bound, by = _bound_ms(
        B * (sub - 1 + taps + taps + 2 * sub - 1 + taps // rate) * 4,
        n_ops=B * sub * taps * 5,
        chain_s=(sub + 2 + (taps - 1).bit_length() + 2) * DEP_OP_S)
    return dict(
        max_abs_err=float((pe_k - pe_p).abs().max()), max_norm_err=norm,
        **_times(lambda: cuda_pre_echo.pre_echo_cuda(seg, h0, al, y, rate),
                 200, 50),
        plain_ms=_event_ms(lambda: cuda_pre_echo.pre_echo_plain(
            seg, h0, al, y, rate), 10),
        bound_ms=bound, bound_by=by,
        shape=f"B={B} taps={taps} acc_rate={rate} sub={sub}")


def kernels_phase(dev):
    from webrtc_audio_processing_tpu_torch.models import post_filter
    from webrtc_audio_processing_tpu_torch.models.aec3 import render_buffer
    from webrtc_audio_processing_tpu_torch.ops import (
        biquad,
        cuda_span,
        cuda_window,
    )

    rng = np.random.default_rng(SEED)
    rows = []

    # K1 at the HPF's shape (the row), the decimators' and the PostFilter's.
    k1 = _k1_case(dev, rng,
                  biquad.pack_coeffs(*biquad.HPF_COEFFS[48000]), 480, 2 * B)
    aa, nr = render_buffer.decimator_coeffs()
    others = {
        "decimator": _k1_case(dev, rng, np.concatenate([aa, nr]), 64, B),
        "post_filter": _k1_case(dev, rng, biquad.pack_coeffs(
            post_filter.COEFFS_B_48K, post_filter.COEFFS_A_48K), 480, 2 * B),
    }
    rows.append(dict(
        name="biquad_cascade", route="cuda",
        source="webrtc_audio_processing_tpu_torch/csrc/biquad.cu",
        replaces="webrtc_audio_processing_tpu/ops/pallas_biquad.py:32",
        library_ms=None, library_device_ms=None,
        library_note="none: no core PyTorch call runs a biquad cascade",
        other_shapes=others, **k1,
    ))

    # K2 at the echo remover's chain reads: sf rows (W = 19, F = 512) in the
    # row, the blocks rows (W = 15, F = 384) beside it.
    def k2_case(W, F):
        ring = torch.from_numpy(rng.standard_normal(
            (B, 200, F)).astype(np.float32)).to(dev)
        start = torch.from_numpy(
            rng.integers(0, 167, B).astype(np.int32)).to(dev)
        got = cuda_span.span_gather_cuda(ring, start, W)
        want = cuda_span.span_gather_plain(ring, start, W)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"K2 differs from its twin: {err}")
        idx = (start.long()[:, None] + torch.arange(W, device=dev))[
            :, :, None].expand(B, W, F).contiguous()
        bound, by = _bound_ms(2 * B * W * F * 4)
        return dict(
            max_abs_err=err,
            **_times(lambda: cuda_span.span_gather_cuda(ring, start, W),
                     200, 50),
            plain_ms=_event_ms(
                lambda: cuda_span.span_gather_plain(ring, start, W), 50),
            library_ms=_event_ms(lambda: torch.gather(ring, 1, idx), 200),
            library_device_ms=_graph_ms(lambda: torch.gather(ring, 1, idx),
                                        50),
            bound_ms=bound, bound_by=by, shape=f"B={B} LP=200 W={W} F={F}")

    k2 = k2_case(19, 512)
    rows.append(dict(
        name="span_gather", route="cuda",
        source="webrtc_audio_processing_tpu_torch/csrc/span.cu",
        replaces="webrtc_audio_processing_tpu/ops/pallas_span.py:47",
        library_note="torch.gather with a prebuilt index",
        other_shapes={"blocks": k2_case(15, 384)}, **k2))

    # K3 at the matched filter's shapes (5 filters of 512 taps, DS = 2448,
    # sub 16: the specialised form), and the runtime-sub form beside it.
    k3, (low, h0, y, got) = _k3_case(dev, rng, 512, 16)
    rows.append(dict(
        name="matched_filter_nlms", route="cuda",
        source="webrtc_audio_processing_tpu_torch/csrc/matched_filter.cu",
        replaces="webrtc_audio_processing_tpu/ops/pallas_mf.py:31",
        library_ms=None, library_device_ms=None,
        library_note="none: no PyTorch call runs a per-sample NLMS",
        other_shapes={"taps256_sub8": _k3_case(
            dev, np.random.default_rng(SEED + 100), 256, 8)[0]}, **k3))

    # K4 at the winner filter's shapes (the specialised form), and the
    # general form beside it.
    k4 = _k4_case(dev, got[4][:, 0].contiguous(), h0[:, 0].contiguous(),
                  (got[1][:, 0] * 1.0).contiguous(), y, 4)
    other = np.random.default_rng(SEED + 101)
    k4_256 = _k4_case(dev, *(torch.from_numpy(
        (other.standard_normal(shape) * scale).astype(np.float32)).to(dev)
        for shape, scale in (((B, 271), 400.0), ((B, 256), 0.01),
                             ((B, 16), 1e-6), ((B, 16), 400.0))), 8)
    rows.append(dict(
        name="pre_echo_inst", route="cuda",
        source="webrtc_audio_processing_tpu_torch/csrc/pre_echo.cu",
        replaces="webrtc_audio_processing_tpu/ops/pallas_pre_echo.py:59",
        library_ms=None, library_device_ms=None,
        library_note="none: no PyTorch call computes the chunked errors",
        other_shapes={"taps256_rate8": k4_256}, **k4))

    # K5 at the RNN-VAD's shapes: B = 2048, L = 864, W = 480, with the
    # int64 starts the pitch search gives it (rnn_vad/features.py).
    buf = torch.from_numpy(
        rng.standard_normal((B, 864)).astype(np.float32)).to(dev)
    start = torch.from_numpy(rng.integers(0, 385, B)).to(dev)
    w_k = cuda_window.take_windows_cuda(buf, start, 480)
    w_p = cuda_window.take_windows_plain(buf, start, 480)
    torch.cuda.synchronize()
    err = float((w_k - w_p).abs().max())
    if not torch.equal(w_k, w_p):
        raise AssertionError(f"K5 differs from its twin: max |diff| {err}")
    idx = start.long()[:, None] + torch.arange(480, device=dev)
    bound, by = _bound_ms(2 * B * 480 * 4)
    rows.append(dict(
        name="take_windows", route="cuda",
        source="webrtc_audio_processing_tpu_torch/csrc/window.cu",
        replaces="webrtc_audio_processing_tpu/ops/pallas_window.py:21",
        max_abs_err=err,
        **_times(lambda: cuda_window.take_windows_cuda(buf, start, 480),
                 200, 50),
        plain_ms=_event_ms(
            lambda: cuda_window.take_windows_plain(buf, start, 480), 200),
        library_ms=_event_ms(lambda: torch.gather(buf, 1, idx), 200),
        library_device_ms=_graph_ms(lambda: torch.gather(buf, 1, idx), 50),
        library_note="torch.gather with a prebuilt index",
        bound_ms=bound, bound_by=by, shape=f"B={B} L=864 W=480"))

    # K6 at the pair-kernel paths' shapes; the row is 48 kHz stereo with
    # three blocks, the frame pair's odd frame.
    k6 = {name: k6_case(dev, *case, seed=SEED + i)
          for i, (name, case) in enumerate(K6_CASES.items())}
    rows.append(dict(
        name="subtractor_pair", route="cuda",
        source="webrtc_audio_processing_tpu_torch/csrc/subtractor.cu",
        replaces="webrtc_audio_processing_tpu/ops/pallas_subtractor.py:154",
        library_ms=None, library_device_ms=None,
        library_note="none: no PyTorch call runs the subtractor loop",
        other_shapes={k: v for k, v in k6.items() if k != "48k_stereo_nb3"},
        **k6["48k_stereo_nb3"]))
    for r in rows:
        phase("kernel", **r)
    return rows


# ---------------------------------------------------------------- K6 inputs


def k6_inputs(batch, C, R, nb, events, seed, device, below_gate=False,
              jumps=False):
    """Random inputs of K6 made with numpy from ``seed``: per stream the
    subtractor state of tests/test_subtractor_pallas.py:25-51 (random
    filters, H_error, responses; call counters 40, poor-excitation counters
    1200) with render spectra above the gains' noise gate (so the filters
    adapt) or, with ``below_gate``, below it (far-end silence: no filter
    adapts), and with counters that drive the misadjustment rescale (stream 1),
    a coarse reset once the refined error is the smaller (every stream), the
    leakage hangover (stream 2) and a size change in progress (stream 3);
    the packed sf chain, rows [re | im | |X|^2 | 0] at the render buffer's
    width; bins 0 and 64 real in every spectrum, as a real signal's are
    (cuFFT's inverse does not ignore their imaginary parts as the CPU's
    does); window offsets that differ by stream; capture blocks. With
    ``events``: the initial-state transition on block 0, a delay change on
    block 1 of the even streams, poor excitation on block 1 of the odd ones,
    a narrow-band mask on block 1 and a saturated capture on the last
    stream. Window starts move by -1 a block (a chain's trajectory) or,
    with ``jumps``, on every fourth stream from 1 jump to the second chain
    at block 1, from 2 end below the chain's first row and from 3 start
    beyond its last window (the kernel clamps them; ``k6_clamped`` gives
    the twin the clamped starts). The multichannel config (P = 13, Pc = 11)
    with two render channels, the default (P = Pc = 13) with one, as the
    APM selects them. Returns a dict of the arguments of
    ``cuda_subtractor.pair``."""
    from webrtc_audio_processing_tpu_torch.models.aec3 import (
        config as aec3_config,
        render_buffer,
        subtractor,
    )
    from webrtc_audio_processing_tpu_torch.ops import cuda_subtractor

    config = (aec3_config.create_default_multichannel_config() if R > 1
              else aec3_config.EchoCanceller3Config())
    geo = render_buffer.BufferGeometry.create(config, 16000, R)
    rng = np.random.default_rng(seed)
    st = subtractor.init_state(config, R, C, batch, "cpu")
    P, Pc = st.refined.H.shape[2], st.coarse.H.shape[2]
    f32 = np.float32

    def filt(p):
        shape = (batch, C, p, R, 65)
        H = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
        H[..., [0, 64]] = H[..., [0, 64]].real  # the spectra of real signals
        return torch.from_numpy((H * 0.1).astype(np.complex64))

    def per_stream(values, dtype=torch.int32):
        return torch.tensor([values[b % len(values)] for b in range(batch)],
                            dtype=dtype)

    st.refined.H, st.coarse.H = filt(P), filt(Pc)
    st.refined.size_change_counter = per_stream([0, 0, 0, 5])
    st.refined.target_size = per_stream([P - 1, P - 1, P - 1, P])
    for gain in (st.refined_gain, st.coarse_gain):
        gain.call_counter[:] = 40
        gain.poor_excitation_counter[:] = 1200
    st.refined_gain.H_error = torch.from_numpy(
        rng.uniform(10.0, 1000.0, (batch, C, 65)).astype(f32))
    st.refined_frequency_responses = torch.from_numpy(
        rng.uniform(0, 1, (batch, C, P, 65)).astype(f32))
    st.refined_impulse_responses = torch.from_numpy(
        (rng.standard_normal((batch, C, P * 64)) * 0.01).astype(f32))
    st.mis_inv = per_stream([0.0, 20.0, 0.0, 0.0], torch.float32)[:, None] \
        .repeat(1, C)
    st.mis_blocks_acum = (torch.arange(batch, dtype=torch.int32) % 4)[
        :, None].repeat(1, C)
    st.poor_coarse_filter_counters[:] = 4
    st.coarse_filter_reset_hangover = per_stream([0, 0, 3, 0])[:, None] \
        .repeat(1, C)

    L = R * 65
    W2 = 2 * (P + nb - 1)
    level = 100.0 if below_gate else 3000.0
    re = (rng.standard_normal((batch, W2, L)) * level).astype(f32)
    im = (rng.standard_normal((batch, W2, R, 65)) * level).astype(f32)
    im[..., [0, 64]] = 0.0
    im = im.reshape(batch, W2, L)
    chain = np.zeros((batch, W2, geo.sf_row_fp), f32)
    chain[..., :L], chain[..., L:2 * L] = re, im
    chain[..., 2 * L:3 * L] = re * re + im * im
    offsets = ((nb - 1 - np.arange(nb))[None, :]
               + (np.arange(batch) % 3)[:, None]).astype(np.int32)
    if jumps:
        k, W, hi = np.arange(nb), W2 // 2, W2 - P
        offsets[1::4] = np.where(k == 0, nb - 1, W + nb - 1 - k)
        offsets[2::4] = nb - 2 - k
        offsets[3::4] = hi + nb - 1 - k
    ys = (rng.standard_normal((batch, nb, C, 64)) * 1000).astype(f32)
    masks = np.zeros((batch, nb, 65), bool)
    ev = np.zeros((batch, nb, 3), bool)
    sat = np.zeros(batch, bool)
    if events:
        ev[:, 0, 2] = True
        ev[0::2, 1, 1] = True
        ev[1::2, 1, 0] = True
        masks[:, 1, 10:15] = True
        sat[-1] = True
    packed = cuda_subtractor.pack(st)
    return dict(
        config=config, geo=geo,
        st=cuda_subtractor.PairState(*(t.to(device) for t in packed)),
        sf_chain=torch.from_numpy(chain).to(device),
        offsets=torch.from_numpy(offsets).to(device),
        ys=torch.from_numpy(ys).to(device),
        narrow_masks=torch.from_numpy(masks).to(device),
        events=torch.from_numpy(ev).to(device),
        saturated_capture=torch.from_numpy(sat).to(device))


def k6_clamped(inp):
    """``inp`` with each window start clamped into the chain, as the kernel
    clamps it: the twin's arguments."""
    P = inp["st"].H.shape[2]
    hi = inp["sf_chain"].shape[1] - P
    return {**inp, "offsets": inp["offsets"].clamp(0, hi)}


def k6_leaves(result):
    """(name, tensor) of K6's new state and outputs; the scalar slots and
    the per-block scalars column by column, complex planes as float
    pairs."""
    from webrtc_audio_processing_tpu_torch.ops import cuda_subtractor

    st, out = result
    for name in ("H", "H_coarse"):
        yield name, torch.view_as_real(getattr(st, name))
    yield from (("H_error", st.H_error), ("freq", st.freq), ("imp", st.imp))
    for j in range(st.fs.shape[1]):
        yield f"fs[{j}]", st.fs[:, j]
    for j in range(st.iv.shape[1]):
        yield f"iv[{j}]", st.iv[:, j]
    yield from (("e_refined", out.e_refined), ("e_coarse", out.e_coarse))
    for j, key in enumerate(cuda_subtractor.SCALAR_KEYS):
        yield key, out.scalars[..., j]
    yield from (("out.freq", out.freq), ("out.imp", out.imp),
                ("out.size", out.size))


def k6_gaps(out):
    """(e2_refined < e2_coarse, |e2_refined - e2_coarse| in float32 ulps of
    the larger), each (B, nb, C)."""
    e2r = out.scalars[..., 1].double()
    e2c = out.scalars[..., 2].double()
    ulp = torch.finfo(torch.float32).eps * torch.maximum(e2r.abs(), e2c.abs())
    return e2r < e2c, (e2r - e2c).abs() / torch.clamp(ulp, min=1e-30)


def k6_compare(got, want):
    """Leaf by leaf, with the tie rule at K6_TIE_ULPS: (the largest error
    relative to the leaf's scale over the float leaves, the largest
    absolute error, the leaves that fail, the tie splits: streams that took
    the other branch of a tie, of them the reset splits, and the largest
    gap in ulps of a split decision)."""
    from webrtc_audio_processing_tpu_torch.ops import cuda_subtractor as cs

    (dg, gap_g), (dw, gap_w) = k6_gaps(got[1]), k6_gaps(want[1])
    split = ((dg != dw) & (gap_g <= K6_TIE_ULPS) & (gap_w <= K6_TIE_ULPS))
    tie = split.flatten(1).any(dim=1)
    C = got[0].H.shape[1]
    hang = slice(cs.NI_SHARED + 3 * C, cs.NI_SHARED + 4 * C)
    reset = (got[0].iv[:, hang] != want[0].iv[:, hang]).any(dim=1) & tie
    keep = ~reset
    rel, err, bad = 0.0, 0.0, []
    for (name, g), (_, w) in zip(k6_leaves(got), k6_leaves(want)):
        if not w.dtype.is_floating_point:
            differ = (g != w).reshape(g.shape[0], -1).any(dim=1)
            if bool((differ & ~tie).any()):
                bad.append(name)
            continue
        g, w = g[keep].double(), w[keep].double()
        d = float((g - w).abs().max()) if g.numel() else 0.0
        err = max(err, d)
        rel = max(rel, d / max(float(w.abs().max()), 1e-3))
    n_reset = int(reset.sum())
    if n_reset > K6_MAX_RESET_SPLITS * reset.numel():
        bad.append(f"{n_reset} reset splits")
    splits = dict(
        tie_streams=int(tie.sum()), reset_splits=n_reset,
        max_split_gap_ulps=float(torch.maximum(gap_g, gap_w)[split].max())
        if bool(split.any()) else None)
    return rel, err, bad, splits


def k6_bound(inp):
    """K6's least time: each state plane read and written once, the chain
    rows the windows cover (re, im and spectrum), the per-block inputs and
    outputs; the operations at this state's filter sizes."""
    from webrtc_audio_processing_tpu_torch.ops import cuda_subtractor as cs

    st = inp["st"]
    Bn, C, P, R, _ = st.H.shape
    nb = inp["ys"].shape[1]
    L = R * 65
    offs = k6_clamped(inp)["offsets"].cpu().numpy()
    covered = np.zeros((Bn, inp["sf_chain"].shape[1]), bool)
    for k in range(nb):
        covered[np.arange(Bn)[:, None], offs[:, k:k + 1] + np.arange(P)] = True
    n_bytes = 2 * sum(t.numel() * t.element_size() for t in st)
    n_bytes += int(covered.sum()) * 3 * L * 4
    n_bytes += sum(inp[k].numel() * inp[k].element_size() for k in (
        "offsets", "ys", "narrow_masks", "events", "saturated_capture"))
    n_bytes += Bn * nb * C * (2 * 64 + 7 + P * 65 + P * 64) * 4 + Bn * nb * 4
    iv = st.iv.cpu()
    sizes = (iv[:, cs.I_R_CUR] + iv[:, cs.I_C_CUR]).double()
    # Per (stream, channel, block): apply and adapt of both filters (8
    # operations per complex multiply-add), the spectral sums, the two
    # prediction errors and error FFTs, two constrains per render channel,
    # the frequency response.
    per_block = (16 * L * sizes + L * P + 2 * 64 * 63 * 4 + 2 * 65 * 64 * 4
                 + 2 * R * (64 * 63 + 65 * 64) * 4 + 3 * L * P)
    return _bound_ms(n_bytes, float(per_block.sum()) * C * nb)


def k6_case(dev, batch, C, R, nb, events, below_gate, jumps, seed):
    from webrtc_audio_processing_tpu_torch.ops import cuda_subtractor

    inp = k6_inputs(batch, C, R, nb, events, seed, dev, below_gate, jumps)
    config, _, *args = inp.values()
    got = cuda_subtractor.pair_cuda(config, *args)
    twin = k6_clamped(inp)
    want = cuda_subtractor.pair_plain(*twin.values())
    torch.cuda.synchronize()
    rel, err, unequal, splits = k6_compare(got, want)
    shape = (f"B={batch} C={C} R={R} P={inp['st'].H.shape[2]} "
             f"Pc={inp['st'].H_coarse.shape[2]} nb={nb} events={events} "
             f"below_gate={below_gate} jumps={jumps}")
    if rel > K6_RTOL or unequal:
        raise AssertionError(
            f"K6 differs from its twin ({shape}): {rel} of scale, failing "
            f"leaves {unequal}, tie splits {splits}")
    bound, by = k6_bound(inp)
    return dict(
        max_abs_err=err, max_rel_err=rel,
        tie_splits=splits,
        **_times(lambda: cuda_subtractor.pair_cuda(config, *args), 20, 10),
        plain_ms=_event_ms(
            lambda: cuda_subtractor.pair_plain(*twin.values()), 3),
        bound_ms=bound, bound_by=by, shape=shape)


# --------------------------------------------------------------- inputs


def echo_scene(n_frames, seed, streams, rate=48000, channels=2):
    """The render scene of tests/test_apm_48k_stereo.py per stream (a noise
    burst train with a slow level swing, the same far end on every
    channel; the phases from the stream's own generator), and the capture:
    its echo through a short path per channel (two paths in stereo) plus
    -40 dBFS noise. Returns (render, capture), each (len(streams), n,
    channels) float32 in [-1, 1], n = rate / 100 * n_frames."""
    n = n_frames * rate // 100
    t = (np.arange(n) / float(rate)).astype(np.float32)
    render = np.empty((len(streams), n, channels), np.float32)
    capture = np.empty((len(streams), n, channels), np.float32)
    paths = ((0.4, 0.15, 5), (0.35, 0.12, 9))[:channels]
    for i, s in enumerate(streams):
        rng = np.random.default_rng([seed, s])
        p1, p2 = rng.uniform(0, 2 * np.pi, 2)
        burst = (np.sin(2 * np.pi * 2.3 * t + p1) > -0.2).astype(np.float32)
        level = 0.15 + 0.85 * np.abs(np.sin(2 * np.pi * 0.4 * t + p2))
        far = rng.standard_normal(n, dtype=np.float32) * (0.2 * burst * level)
        for ch, (direct, late, lag) in enumerate(paths):
            render[i, :, ch] = far
            capture[i, :, ch] = direct * far + late * np.roll(far, lag)
        capture[i] += 0.01 * rng.standard_normal((n, channels),
                                                 dtype=np.float32)
    return render, capture


def erle_db(capture, render, out, frame=480):
    """ERLE over the last third as tests/test_apm_48k_stereo.py measures
    it: capture and output power where the far end is active, the last
    frame left out. Arrays (S, n, channels); returns (S,) dB."""
    n, channels = capture.shape[1:]
    tail = slice(2 * n // 3, n - frame)
    act = np.abs(render[:, tail, 0]) > 1e-4
    e_in = (capture[:, tail] ** 2 * act[..., None]).sum(axis=(1, 2)) / (
        channels * act.sum(axis=1)) + 1e-12
    e_out = (out[:, tail] ** 2 * act[..., None]).sum(axis=(1, 2)) / (
        channels * act.sum(axis=1)) + 1e-12
    return 10 * np.log10(e_in / e_out)


def select_streams(state, idx, device):
    """The state of streams ``idx`` (batch axis first) on ``device``; plain
    ints (the frame counter) carry over and 0-d tensors (AEC3's block
    ordinal, uniform across the batch) are copied. CUDA indexes no uint32
    tensor (the comfort-noise seed), so those go through int64."""
    if state is None or isinstance(state, int):
        return state
    if dataclasses.is_dataclass(state):
        return type(state)(**{
            f.name: select_streams(getattr(state, f.name), idx, device)
            for f in dataclasses.fields(state)
        })
    if state.dim() == 0:
        return state.to(device, copy=True)
    if state.dtype == torch.uint32:
        return state.to(torch.int64)[idx].to(device).to(torch.uint32)
    return state[idx].to(device)


def _kernel_modules():
    from webrtc_audio_processing_tpu_torch.ops import (
        cuda_biquad,
        cuda_matched_filter,
        cuda_pre_echo,
        cuda_span,
        cuda_subtractor,
        cuda_window,
    )

    return {"biquad_cascade": cuda_biquad, "span_gather": cuda_span,
            "matched_filter_nlms": cuda_matched_filter,
            "pre_echo_inst": cuda_pre_echo, "take_windows": cuda_window,
            "subtractor_pair": cuda_subtractor}


def _reset_counts():
    for m in _kernel_modules().values():
        m.launches = 0


def _counts():
    return {k: m.launches for k, m in _kernel_modules().items()}


SYNC_WARNING = "called a synchronizing CUDA operation"


def _sync_count(fn):
    """The synchronizing calls ``fn`` makes, from PyTorch's sync debug mode
    (the closing synchronize runs after the mode is off; the mode's own
    one-time notice is not counted): (count, the source lines that made
    them)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    hits = [w for w in caught if SYNC_WARNING in str(w.message)]
    return len(hits), sorted({f"{w.filename}:{w.lineno}" for w in hits})


# ------------------------------------------------------------ AEC3 paths

# mode: (rate, channels, maximum internal rate), bench.py:30-34.
BENCH_MODES = {"48k_stereo": (48000, 2, 48000), "16k_mono": (16000, 1, 32000)}


def aec3_config(cfg_mod, mode="48k_stereo"):
    """``bench.build_step``'s configuration (bench.py:53-78) for ``mode``."""
    _, channels, internal = BENCH_MODES[mode]
    return cfg_mod.Config().replace(
        pipeline=cfg_mod.Pipeline(multi_channel_capture=channels > 1,
                                  multi_channel_render=channels > 1,
                                  maximum_internal_processing_rate=internal),
        high_pass_filter=cfg_mod.HighPassFilter(enabled=True),
        echo_canceller=cfg_mod.EchoCanceller(enabled=True),
        noise_suppression=cfg_mod.NoiseSuppression(enabled=True),
        gain_controller2=cfg_mod.GainController2(
            enabled=True,
            adaptive_digital=cfg_mod.AdaptiveDigital(enabled=True)),
    )


def aec3_geometry(mode, pair_kernel=None):
    """The APM geometry of ``mode``; ``pair_kernel`` None follows the JAX
    package's ``AEC3_PAIR_KERNEL`` switch."""
    from webrtc_audio_processing_tpu_torch import apm, config as cfg_mod
    from webrtc_audio_processing_tpu_torch.models.aec3 import echo_canceller3

    if pair_kernel is None:
        pair_kernel = echo_canceller3.pair_kernel_from_env()
    rate, channels, _ = BENCH_MODES[mode]
    return apm.ApmGeometry.create(
        aec3_config(cfg_mod, mode), rate, channels, render_input_rate=rate,
        num_render_channels=channels, aec3_stereo_content=channels > 1,
        aec3_pair_kernel=pair_kernel)


def expected_aec3_launches(n_frames, rate=48000, pair_kernel=False):
    """Per frame pair: K1 2 HPF + 2 PostFilter (48 kHz only) + 5 render and
    5 capture decimations (one launch for both cascades); K2 the echo
    remover's four chain reads per frame; K3 and K4 one per capture block;
    K5 one per frame; K6 one per frame on the pair-kernel path."""
    pairs, odd = divmod(n_frames, 2)
    blocks = 5 * pairs + 2 * odd
    per_frame = 2 if rate == 48000 else 1
    return {"biquad_cascade": per_frame * n_frames + 2 * blocks,
            "span_gather": 4 * n_frames,
            "matched_filter_nlms": blocks, "pre_echo_inst": blocks,
            "take_windows": n_frames,
            "subtractor_pair": n_frames if pair_kernel else 0}


@functools.lru_cache(maxsize=1)
def _scene(mode, batch):
    rate, channels, _ = BENCH_MODES[mode]
    return echo_scene(AEC3_FRAMES, SEED, range(batch), rate, channels)


def aec3_path_phase(dev, smi, path):
    from webrtc_audio_processing_tpu_torch import apm, bench

    rate, channels, _ = BENCH_MODES[path.mode]
    frame, Bp = rate // 100, path.batch
    t0 = time.perf_counter()
    render, capture = _scene(path.mode, Bp)
    ren_dev = torch.from_numpy(render).to(dev)
    cap_dev = torch.from_numpy(capture).to(dev)
    setup_s = time.perf_counter() - t0

    geo = aec3_geometry(path.mode, path.pair_kernel)
    state = apm.init_state(geo, Bp)
    idx = torch.tensor(path.check, device=dev)
    torch.cuda.reset_peak_memory_stats()
    outs, delays, finite, snapshots = [], [], [], []
    cross = path.cross
    timer_start = torch.cuda.Event(enable_timing=True)
    timer_end = torch.cuda.Event(enable_timing=True)
    first_timed = AEC3_FRAMES - AEC3_TIMED
    sync_frame = first_timed - 1
    profiled = range(sync_frame - PROFILED_FRAMES, sync_frame)

    def step(f):
        nonlocal state
        sl = slice(f * frame, (f + 1) * frame)
        state, out, rout, stats = apm.process_stream_pair(
            geo, state, cap_dev[:, sl], ren_dev[:, sl])
        outs.append(out[idx])
        delays.append(stats["delay_ms"][idx])
        finite.append(torch.isfinite(out).all() & torch.isfinite(rout).all())
        return out

    def run(frames):
        for f in frames:
            if f in cross:  # outside the profiled and sync-counted calls
                snapshots.append(select_streams(state, idx, "cpu"))
            if f == profiled[0]:  # the profiler's warm-up, then the rest
                kernels.append(bench.device_kernels(
                    [lambda f=f: step(f)],
                    [lambda g=g: step(g) for g in profiled[1:]]))
            elif f in profiled:
                continue  # stepped in the profiler's session
            elif f == sync_frame:
                syncs[:] = _sync_count(lambda f=f: step(f))
            else:
                step(f)

    kernels, syncs = [], [None, None]
    t_run = time.perf_counter()
    _reset_counts()
    run(range(first_timed))
    torch.cuda.synchronize()
    host_t0 = time.perf_counter()
    timer_start.record()
    run(range(first_timed, AEC3_FRAMES))
    timer_end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - host_t0) * 1000.0 / AEC3_TIMED
    dev_ms = timer_start.elapsed_time(timer_end) / AEC3_TIMED
    run_s = time.perf_counter() - t_run
    launches = _counts()
    want = expected_aec3_launches(AEC3_FRAMES, rate, path.pair_kernel)
    if launches != want:
        raise AssertionError(f"{path.name} launches {launches}, expected "
                             f"{want}")
    if not bool(torch.stack(finite).all()):
        raise AssertionError(f"non-finite output on {path.name}")
    shape = tuple(outs[-1].shape[1:])
    if shape != (frame, channels):
        raise AssertionError(f"output shape {shape}")
    gpu_out = torch.cat(outs, dim=1).cpu().numpy()  # (2, n, channels)
    check = list(path.check)
    erle = erle_db(capture[check], render[check], gpu_out, frame)
    phase(path.name, mode=path.mode, streams=Bp,
          pair_kernel=path.pair_kernel, frames=AEC3_FRAMES,
          timed_frames=AEC3_TIMED, ms_per_frame=host_ms,
          event_ms_per_frame=dev_ms,
          realtime_streams=Bp * min(10.0 / host_ms, 1.0),
          device_kernels_per_frame=kernels[0],
          launches=launches, expected_launches=want,
          host_syncs_per_frame=syncs[0], host_sync_sites=syncs[1],
          sync_counter_check=_sync_count(
              lambda: torch.ones(1, device=dev).item())[0],
          card=smi,
          peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
          erle_db=dict(zip(map(str, path.check), erle.tolist())),
          input_seconds=round(setup_s, 3), run_seconds=round(run_s, 3))
    if not (erle > ERLE_BAR_DB).all():
        raise AssertionError(f"ERLE {erle} dB not above {ERLE_BAR_DB} dB")
    gpu_delay = torch.stack(delays, dim=1).cpu().numpy()
    return (geo, snapshots, render[check], capture[check], gpu_out,
            gpu_delay), launches


def _rel_rms(got, want):
    return np.sqrt(((got - want) ** 2).sum(axis=(1, 2))
                   / (want ** 2).sum(axis=(1, 2)))


def aec3_cross_check_phase(path, geo, snapshots, render, capture, gpu_out,
                           gpu_delay):
    from webrtc_audio_processing_tpu_torch import apm

    frame = BENCH_MODES[path.mode][0] // 100
    frames = path.cross
    free_frames = range(frames[0], frames[0] + FREE_FRAMES)
    t0 = time.perf_counter()

    def cpu_step(state, f):
        sl = slice(f * frame, (f + 1) * frame)
        state, out, _, stats = apm.process_stream_pair(
            geo, state, torch.from_numpy(capture[:, sl].copy()),
            torch.from_numpy(render[:, sl].copy()))
        return state, out.numpy(), stats["delay_ms"].numpy()

    # The check: one step from the card's state before each checked frame.
    seeded = [cpu_step(snap, f)[1:] for snap, f in zip(snapshots, frames)]
    # Beside it, free running from the card's state before the first.
    state, free = snapshots[0], []
    for f in free_frames:
        state, out, delay = cpu_step(state, f)
        free.append((out, delay))

    def compare(runs, fs):
        g = np.concatenate([gpu_out[:, f * frame:(f + 1) * frame]
                            for f in fs], axis=1)
        out = np.concatenate([o for o, _ in runs], axis=1)
        delay = np.stack([d for _, d in runs], axis=1)
        per_frame = [_rel_rms(g[:, k * frame:(k + 1) * frame],
                              out[:, k * frame:(k + 1) * frame]).max()
                     for k in range(len(fs))]
        first = next((f for f, e in zip(fs, per_frame) if e > RTOL_RMS),
                     None)
        return (_rel_rms(g, out),
                bool((delay == gpu_delay[:, list(fs)]).all()), first)

    rel, same_delay, _ = compare(seeded, frames)
    free_rel, free_delay, free_first = compare(free, free_frames)
    phase(f"{path.name}_cross_check", streams=list(path.check),
          frames=len(frames),
          checked=f"{frames.start}:{frames.stop}:{frames.step}",
          free_running_frames=len(free_frames), rel_rms=rel.tolist(),
          delay_ms_equal=same_delay,
          free_running_rel_rms=free_rel.tolist(),
          free_running_delay_ms_equal=free_delay,
          free_running_first_frame_over_bar=free_first,
          cpu_seconds=round(time.perf_counter() - t0, 3))
    if not (rel <= RTOL_RMS).all():
        raise AssertionError(f"relative RMS {rel} exceeds {RTOL_RMS}")
    if not same_delay:
        raise AssertionError("delay_ms differs between card and CPU")


# ------------------------------------------------------- graphed paths


def graphed_path_phase(dev, smi, path, eager_out, eager_delay):
    """Phase 7: ``path`` through the captured pair step, held bit for bit
    to phase 4's eager outputs ``eager_out`` (S, n, channels) and delays
    ``eager_delay`` (S, frames) on the checked streams. Returns the
    launches: captured per pair x replays."""
    from webrtc_audio_processing_tpu_torch import apm, bench, step_graph

    rate, channels, _ = BENCH_MODES[path.mode]
    frame, Bp = rate // 100, path.batch
    render, capture = _scene(path.mode, Bp)
    ren_dev = torch.from_numpy(render).to(dev)
    cap_dev = torch.from_numpy(capture).to(dev)
    geo = aec3_geometry(path.mode, path.pair_kernel)
    idx = torch.tensor(path.check, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    graph = step_graph.PairGraph(geo, apm.init_state(geo, Bp))
    reserved = torch.cuda.memory_reserved()
    _reset_counts()
    graph.capture()
    captured = _counts()
    pool_gb = (torch.cuda.memory_reserved() - reserved) / 1e9
    want = expected_aec3_launches(2, rate, path.pair_kernel)
    if captured != want:
        raise AssertionError(f"{path.name} captured {captured} launches a "
                             f"pair, expected {want}")

    def frames(p):
        f0, f1 = (slice(f * frame, (f + 1) * frame)
                  for f in (2 * p, 2 * p + 1))
        return ren_dev[:, f0], cap_dev[:, f0], ren_dev[:, f1], cap_dev[:, f1]

    replays = AEC3_FRAMES // 2
    first_timed = replays - AEC3_TIMED // 2
    timer_start = torch.cuda.Event(enable_timing=True)
    timer_end = torch.cuda.Event(enable_timing=True)
    outs, delays, finite = [], [], []
    for p in range(replays):
        if p == first_timed:
            torch.cuda.synchronize()
            host_t0 = time.perf_counter()
            timer_start.record()
        for out, rout, stats in graph.replay(*frames(p)):
            outs.append(out[idx])
            delays.append(stats["delay_ms"][idx])
            finite.append(torch.isfinite(out).all()
                          & torch.isfinite(rout).all())
    timer_end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - host_t0) * 1000.0 / AEC3_TIMED
    dev_ms = timer_start.elapsed_time(timer_end) / AEC3_TIMED
    # The state runs on past the scene: the last pair's frames again.
    kernels = bench.device_kernels(
        [lambda: graph.replay(*frames(replays - 1))],
        [lambda: graph.replay(*frames(replays - 1))] * 2) / 2
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not bool(torch.stack(finite).all()):
        raise AssertionError(f"non-finite output on {path.name}, graphed")
    got_out = torch.cat(outs, dim=1).cpu().numpy()
    got_delay = torch.stack(delays, dim=1).cpu().numpy()
    differ = [f for f in range(AEC3_FRAMES) if not np.array_equal(
        got_out[:, f * frame:(f + 1) * frame],
        eager_out[:, f * frame:(f + 1) * frame])]
    same_delay = bool(np.array_equal(got_delay, eager_delay))
    check = list(path.check)
    erle = erle_db(capture[check], render[check], got_out, frame)
    launches = {k: v * replays for k, v in captured.items()}
    phase(f"{path.name}_graphed", mode=path.mode, streams=Bp,
          pair_kernel=path.pair_kernel, frames=AEC3_FRAMES,
          timed_frames=AEC3_TIMED, ms_per_frame=host_ms,
          event_ms_per_frame=dev_ms,
          realtime_streams=Bp * min(10.0 / host_ms, 1.0),
          capture_seconds=graph.capture_seconds,
          device_kernels_per_frame=kernels,
          launches_captured_per_pair=captured, launches=launches,
          bit_equal_to_eager=not differ and same_delay,
          frames_differing_from_eager=len(differ),
          first_frame_differing=differ[0] if differ else None,
          delay_ms_equal_to_eager=same_delay,
          rel_rms_to_eager=_rel_rms(got_out, eager_out).tolist(),
          peak_mem_gb=peak_gb, graph_pool_gb=pool_gb, card=smi,
          erle_db=dict(zip(map(str, path.check), erle.tolist())))
    if differ or not same_delay:
        raise AssertionError(
            f"{path.name} graphed differs from its eager run: {len(differ)} "
            f"frames from frame {differ[0] if differ else None}, delays "
            f"equal {same_delay}")
    if not (erle > ERLE_BAR_DB).all():
        raise AssertionError(f"ERLE {erle} dB not above {ERLE_BAR_DB} dB")
    return launches


# Phase 8's batches, one a mode (the main paths' B).
TWIN_BATCHES = {"48k_stereo": 2048, "16k_mono": 4096}


def bench_twin_phase(dev, smi):
    """Phase 8: the bench twin's measurement at one batch a mode, and the
    line it prints for them."""
    from webrtc_audio_processing_tpu_torch import bench
    from webrtc_audio_processing_tpu_torch.models.aec3 import echo_canceller3

    pair_kernel = echo_canceller3.pair_kernel_from_env()
    best, results = {}, {}
    for mode, n in TWIN_BATCHES.items():
        geo = bench.build_geometry(mode, pair_kernel)
        rng = np.random.default_rng(0)
        best[mode], results[mode] = bench.measure_streams(
            mode, float("inf"), (n,),
            lambda b, geo=geo, rng=rng: bench.throughput(geo, b, rng, dev))
        if n not in results[mode] or best[mode] <= 0:
            raise AssertionError(f"the bench twin measured nothing at {mode} "
                                 f"B = {n}")
    phase("bench_twin", line=bench.result_line(
        best["48k_stereo"], best["16k_mono"], results, smi, pair_kernel))


# ----------------------------------------------------------- slice-1 path


def slice_config(cfg_mod):
    return cfg_mod.Config().replace(
        pipeline=cfg_mod.Pipeline(multi_channel_capture=True,
                                  multi_channel_render=True,
                                  maximum_internal_processing_rate=48000),
        high_pass_filter=cfg_mod.HighPassFilter(enabled=True),
        noise_suppression=cfg_mod.NoiseSuppression(enabled=True),
        gain_controller2=cfg_mod.GainController2(
            enabled=True,
            adaptive_digital=cfg_mod.AdaptiveDigital(enabled=True)),
    )


def speech_like(n_frames, seed):
    """(n_frames, B, 480, 2) in [-1, 1]: per stream a 7-harmonic tone at
    90-250 Hz, amplitude-modulated at 2-5 Hz, plus -40 dBFS noise."""
    rng = np.random.default_rng(seed)
    f0 = rng.uniform(90, 250, (B, 1)).astype(np.float32)
    fm = rng.uniform(2, 5, (B, 1)).astype(np.float32)
    amp = rng.uniform(0.05, 0.2, (B, 1)).astype(np.float32)
    ph = rng.uniform(0, 2 * np.pi, (B, 1)).astype(np.float32)
    out = np.empty((n_frames, B, 480, 2), np.float32)
    for f in range(n_frames):
        t = ((f * 480 + np.arange(480, dtype=np.float32)) / 48000.0)[None, :]
        sig = np.zeros((B, 480), np.float32)
        for k in range(1, 8):
            sig += np.sin(2 * np.pi * f0 * k * t + k * ph) / k
        sig *= amp * (0.6 + 0.4 * np.sin(2 * np.pi * fm * t))
        noise = rng.standard_normal((B, 480, 2)).astype(np.float32)
        out[f] = sig[:, :, None] + 0.01 * noise
    return out


def slice_path_phase(dev, smi):
    from webrtc_audio_processing_tpu_torch import apm, config as cfg_mod

    geo = apm.ApmGeometry.create(slice_config(cfg_mod), 48000, 2,
                                 num_render_channels=2)
    n = 1 + SLICE_WARMUP + SLICE_TIMED
    captures = speech_like(n, SEED)
    renders = speech_like(n, SEED + 1)
    cap_dev = torch.from_numpy(captures).to(dev)
    ren_dev = torch.from_numpy(renders).to(dev)

    # Onset frame (set-up): a stream's first frame searches pitch in a
    # mostly empty buffer, where near-ties make the period depend on float
    # noise; the compared run starts from the state after it.
    state = apm.init_state(geo, B)
    state, _, _, _ = apm.process_stream_pair(geo, state, cap_dev[0],
                                             ren_dev[0])
    idx = torch.tensor(SLICE_CHECK, device=dev)
    cpu_state = select_streams(state, idx, "cpu")
    torch.cuda.synchronize()

    outs, probs, finite = [], [], []

    def step(f):
        nonlocal state
        state, out, rout, stats = apm.process_stream_pair(
            geo, state, cap_dev[f], ren_dev[f])
        outs.append(out[idx])
        probs.append(stats["agc2_speech_probability"][idx])
        finite.append(torch.isfinite(out).all() & torch.isfinite(rout).all())
        return out

    timer_start = torch.cuda.Event(enable_timing=True)
    timer_end = torch.cuda.Event(enable_timing=True)
    _reset_counts()
    syncs = None
    for f in range(1, n):
        if f == SLICE_WARMUP:
            syncs, _ = _sync_count(lambda f=f: step(f))
            continue
        if f == 1 + SLICE_WARMUP:
            torch.cuda.synchronize()
            host_t0 = time.perf_counter()
            timer_start.record()
        out = step(f)
    timer_end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - host_t0) * 1000.0 / SLICE_TIMED
    dev_ms = timer_start.elapsed_time(timer_end) / SLICE_TIMED
    launches = _counts()
    want = {k: 0 for k in launches}
    want.update(biquad_cascade=n - 1, take_windows=n - 1)
    if launches != want:
        raise AssertionError(f"slice path launches {launches}, expected "
                             f"{want}")
    if not bool(torch.stack(finite).all()):
        raise AssertionError("non-finite output on the slice path")
    if tuple(out.shape) != (B, 480, 2):
        raise AssertionError(f"output shape {tuple(out.shape)}")
    phase("slice_path", streams=B, frames=n - 1, timed_frames=SLICE_TIMED,
          ms_per_frame=host_ms, event_ms_per_frame=dev_ms,
          realtime_streams=B * min(10.0 / host_ms, 1.0), launches=launches,
          host_syncs_per_frame=syncs, card=smi)

    # Cross-check: the same streams on the CPU port.
    state = cpu_state
    cpu_outs, cpu_probs = [], []
    t0 = time.perf_counter()
    for f in range(1, n):
        state, out, _, stats = apm.process_stream_pair(
            geo, state, torch.from_numpy(captures[f, list(SLICE_CHECK)]),
            torch.from_numpy(renders[f, list(SLICE_CHECK)]))
        cpu_outs.append(out.numpy())
        cpu_probs.append(stats["agc2_speech_probability"].numpy())
    gpu_out = torch.stack(outs, dim=1).cpu().numpy()
    gpu_prob = torch.stack(probs, dim=1).cpu().numpy()
    cpu_out = np.stack(cpu_outs, axis=1)
    cpu_prob = np.stack(cpu_probs, axis=1)
    rel = np.sqrt(((gpu_out - cpu_out) ** 2).sum(axis=(1, 2, 3))
                  / (cpu_out ** 2).sum(axis=(1, 2, 3)))
    dprob = np.abs(gpu_prob - cpu_prob).max(axis=1)
    phase("slice_cross_check", streams=list(SLICE_CHECK),
          frames=int(cpu_out.shape[1]), rel_rms=rel.tolist(),
          max_abs_dprob=dprob.tolist(),
          cpu_seconds=round(time.perf_counter() - t0, 3))
    if not (rel <= RTOL_RMS).all():
        raise AssertionError(f"relative RMS {rel} exceeds {RTOL_RMS}")
    if not (dprob <= PROB_ATOL).all():
        raise AssertionError(f"speech probability differs by {dprob}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kernels-only", action="store_true",
                        help="run the device, build and kernel phases only "
                             "and print no result line")
    args = parser.parse_args(argv)
    t_all = time.perf_counter()
    smi = device_phase()
    dev = torch.device("cuda", 0)
    build_phase()
    rows = kernels_phase(dev)
    if args.kernels_only:
        phase("wall_seconds", total=round(time.perf_counter() - t_all, 3))
        return 0
    walls, launches = {}, {}
    for path in AEC3_PATHS:
        t0 = time.perf_counter()
        run, launches[path.name] = aec3_path_phase(dev, smi, path)
        t1 = time.perf_counter()
        aec3_cross_check_phase(path, *run)
        t2 = time.perf_counter()
        graphed = f"{path.name}_graphed"
        launches[graphed] = graphed_path_phase(dev, smi, path, *run[4:])
        walls[path.name] = round(t1 - t0, 3)
        walls[f"{path.name}_cross_check"] = round(t2 - t1, 3)
        walls[graphed] = round(time.perf_counter() - t2, 3)
    t2 = time.perf_counter()
    slice_path_phase(dev, smi)
    t3 = time.perf_counter()
    bench_twin_phase(dev, smi)
    t4 = time.perf_counter()
    phase("wall_seconds", **walls, slice_path=round(t3 - t2, 3),
          bench_twin=round(t4 - t3, 3), total=round(t4 - t_all, 3))
    # Each kernel's launches on the path it serves: K6 on the 48 kHz stereo
    # pair-kernel path, K1-K5 on the default one; every path beside them,
    # the graphed ones as launches captured per pair x replays.
    for r in rows:
        main_path = ("pair_kernel_48k" if r["name"] == "subtractor_pair"
                     else "aec3_path")
        r["launches"] = launches[main_path][r["name"]]
        r["launches_by_path"] = {p: n[r["name"]] for p, n in launches.items()}
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_device_ms", "library_note",
            "launches_by_path")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
