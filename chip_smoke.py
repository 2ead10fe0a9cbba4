"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its result; any failed check raises and the script
exits non-zero without a result line:

1. device: the card's name and power limit; TF32 off.
2. build: the CUDA kernels built from ``webrtc_audio_processing_tpu_torch/
   csrc`` with nvcc (sm_90a, one nvcc per source, all at once) and loaded
   with ctypes.
3. kernels: K1 (biquad cascade, at the HPF's, the AEC3 decimators' and the
   PostFilter's shapes, and at the main path's: its HPF, its QMF branches
   in the all-pass form, its decimators), K2 (ring span read), K3
   (matched-filter NLMS bank; the specialised form at the path's taps 512,
   sub 16, the general form at taps 256, sub 8), K4 (pre-echo errors;
   taps 512, acc_rate 4, and the general form at taps 256, acc_rate 8), K5
   (window read); K2-K5 also at the main path's B = 4096; and K6 (the
   subtractor pair kernel, at 48 kHz stereo for 2 and 3 blocks with and
   without events, and at 16 kHz mono; both geometries also with render
   spectra below the gains' noise gate; 48 kHz stereo also with window
   starts that jump to the second chain or clamp at either end of it, the
   twin given the clamped starts) against their plain PyTorch twins on
   the card at the main paths' shapes; K1 also at the analytics VAD's
   shapes (phase 11's B = 4096) and at the mobile path's HPF (phase 12's
   16 kHz table, B = 4096), and AGC1's limiter kernel at phase 11's rows.
   Each row gives the call time (CUDA
   events around back-to-back calls from Python: what a caller pays, host
   work included), the device time (the calls captured in a CUDA graph and
   replayed: the kernel alone), the device kernels one call runs, the twin's
   call time and, for K2 and K5, the same two times of the one PyTorch call
   that computes the same function (``torch.gather`` on a prebuilt index).
4. Four AEC3 paths through ``apm.process_stream_pair`` with HPF, AEC3, NS
   and AGC2, each 300 frames (3 s) of an echo scene with the last 100
   frames timed:
   - ``default_48k``, the main path: B = 4096 streams of 48 kHz stereo
     through ``Config()``'s own ``Pipeline()`` (internal rate capped at
     32 kHz, multichannel off): the AudioBuffer resamples 48 -> 32 kHz
     and back, the QMF splits two bands (K1), capture is processed mono
     and the render downmixed, the plain subtractor, no PostFilter;
   and the bench's configurations (bench.py:30-78):
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
   (every eighth or twelfth frame from 76 to 195, the untimed run after
   the delay has locked): relative RMS <= 1e-3 and the same delay on every
   checked frame. A free-running rerun over the 10 frames from the first
   checked one is printed beside it: AEC3 turns float noise into
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
9. ``api_48k_stereo``: one ``api.AudioProcessing`` on the card with
   ``Config()``'s pipeline (HPF, AEC3, NS, AGC2 with the RNN-VAD) at 48 kHz
   stereo, fed stream 0 of the main path's scene for 200 frames
   (``process_reverse_stream``, then ``process_stream``). Its outputs must
   be bit-equal on every frame to ``apm.process_stream_pair`` at B = 1 on
   the frames it processed (the same kernels in the same order at the same
   B), ``get_statistics().delay_ms`` the direct path's delay, ERLE above
   6 dB and the launches as ``expected_aec3_launches`` gives. It prints the
   host ms per frame (reverse + capture) and the device kernels per frame.
10. ``engine_default_48k``: ``runtime.StreamingPlane`` and ``BatchEngine``
   on ``runtime.apm_step_fn``'s step (the one-frame step captured as one
   graph per frame of the period, ``step_graph.FrameGraphs``) at B = 4096
   of ``default_48k``: the first 120 frames of phase 4's scene through the
   plane, producer threads filling the queues before the engine steps,
   bit-equal on the checked streams to phase 4's eager outputs; then 40
   frames in which every 8th stream misses every 5th frame, bit-equal to an
   eager ``process_stream_pair`` fed zeros there; frames processed and
   dropped per stream as pushed. It prints host ms per frame of the pushes,
   ``collect_batch``, the host-to-device copy and the replay, the
   device-to-host copy and ``distribute_batch``, and the engine's whole
   step; the real-time streams beside phase 7's graphed ``default_48k``;
   the peak device memory.
11. ``agc1_hybrid_48k``: ``Config()``'s pipeline at 48 kHz stereo with HPF,
   AEC3, NS and ``GainController1(enabled=True)`` (adaptive analog through
   the hybrid AgcManagerDirect with its analytics VAD, the layout of
   PulseAudio's WebRTC echo canceller), AGC2 off, B = 4096 for 600 frames
   (the main path's 300-frame echo scene twice), the odd streams also
   carrying a quiet voiced near end (tests/test_agc_manager_apm.py's
   ``_voiced`` at 0.1 of full scale, ``AGC1_VOICE_AMP``), the applied
   volume starting at 100 and taking frame 1's recommended level on the
   device between pairs. First 60 frames eagerly
   (``step_graph.step_pair``, the volume closed the same way), counting every
   kernel's launches, AGC1's limiter (``agc1_limiter``) and the analytics
   VAD's K1 cascades among them; then the whole run through
   ``step_graph.PairGraph`` at the cadence's period 6 (three pair graphs),
   bit-equal to the eager run on the checked streams over its 60 frames
   (outputs, delays, recommended levels), with no host sync in a replay;
   the odd checked streams' level ends above 100, the even ones' ERLE over
   the last third is above 6 dB; and one pair from the card's state before
   frame 560 rerun on the CPU for the checked streams: relative RMS <=
   1e-5 and AGC1's and the manager's integer leaves equal. It prints the
   graphed ms per frame (host clock and CUDA events), real-time streams,
   device kernels per frame, the captures' seconds and the peak device
   memory, beside phase 7's graphed ``default_48k``.
12. ``aecm_fixed_16k``: the reference's fixed profile
   (WEBRTC_AUDIOPROC_FIXED_PROFILE, its Android build: AECM in mobile
   mode, AGC1 adaptive digital, NS, HPF; ``aecm_config``) at 16 kHz mono,
   B = 4096 for 600 frames (6 s, tests/test_aecm_apm.py's length) of
   ``aecm_scene``: per stream a speech-like far end, its echo 20, 30 or
   50 ms late with a smear, a voiced near end on the odd streams, every
   stream reporting a 20 ms delay. First 60 frames eagerly
   (``step_graph.step_pair``, the delay an input), counting K1's and the
   limiter's launches; then the whole run through ``step_graph.PairGraph``
   (period 2) from init_state, bit-equal to the eager run on every stream
   over its 60 frames (outputs, AGC1's levels, AECM's and AGC1's integer
   leaves), with no host sync in a replay; ERLE over the last third above
   8 dB on the checked echo-only streams and on 99% of all of them
   (``AECM_ERLE_SHARE``: AECM lets a few streams' echo through for a while,
   in the JAX package too); AECM alone from the card's state of 8
   streams at frame 400, buffer_farend and process_frame on the card and
   on the CPU for 10 frames of the scene's int16 frames, bit for bit; one
   pair from the card's state before frame 560 rerun on the CPU for the
   checked streams: relative RMS <= 1e-3 and AGC1's level within +-1. It
   prints the graphed ms per frame (host clock and CUDA events), real-time
   streams, device kernels per frame, the capture's seconds and the peak
   device memory beside phase 7's graphed ``default_48k``; then AGC1's
   limiter timed on one eager frame's own gains (``kernel_on_path_data``).
13. ``aecm_fixed_8k``: the fixed profile at 8 kHz mono (processed at
   16 kHz, AECM with it), B = 64 for 40 frames, eager then graphed from
   init_state, bit-equal on every frame, every stream past AECM's startup.

Before the last line the kernel table as JSON (each kernel's
``launches`` from the main path, K6's from ``pair_kernel_48k``, AGC1's
limiter's from ``agc1_hybrid_48k``, and ``launches_by_path`` from every
path, phases 9-13 included), then the result JSON. The script
imports no JAX.

    python3 chip_smoke.py --kernels-only

runs phases 1-3 alone and prints no result line.
"""

from __future__ import annotations

import argparse
import concurrent.futures
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
FREE_FRAMES = 10

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


# The cross-checks run on one CPU core (~0.7 s a frame at 48 kHz): 15 and
# 10 frames keep the script near 900 s of its 1200 s limit with the mobile
# path's phases. They are spread over frames 76-195, before the profiled
# and timed frames.
# ``default_48k`` is the main path: the APM's own default pipeline.
AEC3_PATHS = (
    Aec3Path("default_48k", "default_48k", 4096, False, (0, 4095),
             range(76, 196, 8)),
    Aec3Path("aec3_path", "48k_stereo", B, False, (0, B - 1),
             range(76, 196, 12)),
    Aec3Path("pair_kernel_48k", "48k_stereo", B, True, (0, B - 1),
             range(76, 196, 12)),
    Aec3Path("pair_kernel_16k_mono", "16k_mono", 4096, True, (0, 4095),
             range(76, 196, 8)),
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

    from webrtc_audio_processing_tpu_torch.runtime import streaming

    t0 = time.perf_counter()
    # The streaming plane's g++ build runs beside the kernels' nvcc builds.
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        plane = pool.submit(streaming._build_library)
        lib = cuda_build.library()
        plane_path = plane.result()
    phase("build", seconds=round(time.perf_counter() - t0, 3),
          nvcc_seconds=round(lib.build_seconds, 3), library=lib.path.name,
          streaming_plane=plane_path.name,
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


def _k1_case(dev, rng, coeffs_np, T, M, allpass=False):
    from webrtc_audio_processing_tpu_torch.ops import cuda_biquad

    K = coeffs_np.shape[0]
    coeffs = torch.from_numpy(coeffs_np).to(dev)
    x_t = torch.from_numpy(
        (rng.standard_normal((T, M)) * 3000).astype(np.float32)).to(dev)
    st = torch.from_numpy(
        (rng.standard_normal((4 * K, M)) * 1000).astype(np.float32)).to(dev)
    st_k, y_k = cuda_biquad.cascade_cuda(coeffs, st, x_t, allpass)
    st_p, y_p = cuda_biquad.cascade_plain(coeffs, st, x_t, allpass)
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
        **_times(lambda: cuda_biquad.cascade_cuda(coeffs, st, x_t, allpass),
                 50, 50),
        plain_ms=_event_ms(lambda: cuda_biquad.cascade_plain(
            coeffs, st, x_t, allpass), 2),
        bound_ms=bound, bound_by=by,
        shape=f"K={K} T={T} M={M}" + (" all-pass" if allpass else ""),
    )


def _k3_case(dev, rng, taps, sub, B=B):
    """K3 against its twin at (taps, sub) on the matched filter's ring for
    B streams, timed; returns the row's fields and the inputs K4 reuses."""
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

    B, taps, sub = h0.shape[0], h0.shape[1], y.shape[1]
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
    from webrtc_audio_processing_tpu_torch.models.vad import analytics_vad
    from webrtc_audio_processing_tpu_torch.ops import (
        biquad,
        cuda_span,
        cuda_window,
        qmf,
    )

    rng = np.random.default_rng(SEED)
    rows = []

    # K1 at the 48 kHz stereo HPF's shape (the row), the decimators' and the
    # PostFilter's; then at ``default_48k``'s (B = 4096): its HPF (the 48 kHz
    # table on both channels at 32 kHz), its QMF branches (the all-pass rows
    # over the render's and the narrowed capture's B lanes, and over the
    # capture's 2 B lanes before the narrowing) and its decimators.
    hpf48 = biquad.pack_coeffs(*biquad.HPF_COEFFS[48000])
    k1 = _k1_case(dev, rng, hpf48, 480, 2 * B)
    aa, nr = render_buffer.decimator_coeffs()
    others = {
        "decimator": _k1_case(dev, rng, np.concatenate([aa, nr]), 64, B),
        "post_filter": _k1_case(dev, rng, biquad.pack_coeffs(
            post_filter.COEFFS_B_48K, post_filter.COEFFS_A_48K), 480, 2 * B),
    }
    main_rng = np.random.default_rng(SEED + 106)
    others.update({
        "default_48k_hpf": _k1_case(dev, main_rng, hpf48, 320, 2 * 4096),
        "default_48k_qmf": _k1_case(
            dev, main_rng, qmf.allpass_rows(qmf.ALLPASS_COEF_1), 160, 4096,
            allpass=True),
        "default_48k_qmf_capture_analysis": _k1_case(
            dev, main_rng, qmf.allpass_rows(qmf.ALLPASS_COEF_2), 160,
            2 * 4096, allpass=True),
        "default_48k_decimator": _k1_case(
            dev, main_rng, np.concatenate([aa, nr]), 64, 4096),
    })
    # The mobile path's HPF (phase 12, aecm_fixed_16k): the 16 kHz table
    # over B = 4096 mono lanes.
    others["aecm_fixed_16k_hpf"] = _k1_case(
        dev, np.random.default_rng(SEED + 109),
        biquad.pack_coeffs(*biquad.HPF_COEFFS[16000]), 160, 4096)
    # The analytics VAD's cascades at phase 11's B = 4096 (one capture
    # channel): its pole-zero HPF every frame; on phase 2 the pre-filter
    # bank's input-HPF poles, composite all-pass (both channels' lanes)
    # and branch all-passes (main and lookahead signals' lanes), the pitch
    # analysis's HPF, its decimator's all-pass and the decimated low-pass.
    av = analytics_vad
    vad_rng = np.random.default_rng(SEED + 107)
    others.update({
        "agc1_vad_pole_zero_hpf": _k1_case(dev, vad_rng, av._HPF_ROWS, 160,
                                           4096),
        "agc1_vad_input_hpf_poles": _k1_case(dev, vad_rng, av._HP_IN_POLES,
                                             480, 4096),
        "agc1_vad_composite_allpass": _k1_case(
            dev, vad_rng, av._ROWS[id(av.COMPOSITE_AP)], 240, 2 * 4096,
            allpass=True),
        "agc1_vad_branch_allpass": _k1_case(
            dev, vad_rng, av._ROWS[id(av.UPPER_AP)], 240, 2 * 4096,
            allpass=True),
        "agc1_vad_pitch_hpf": _k1_case(dev, vad_rng, av._PITCH_HP_ROWS, 240,
                                       4096),
        "agc1_vad_decimator_allpass": _k1_case(
            dev, vad_rng, av._ROWS[id(av.LOWER_AP)], 120, 4096,
            allpass=True),
        "agc1_vad_lowpass": _k1_case(dev, vad_rng, av._DEC_LOWPASS, 120,
                                     4096),
    })
    rows.append(dict(
        name="biquad_cascade", route="cuda",
        source="webrtc_audio_processing_tpu_torch/csrc/biquad.cu",
        replaces="webrtc_audio_processing_tpu/ops/pallas_biquad.py:32",
        library_ms=None, library_device_ms=None,
        library_note="none: no core PyTorch call runs a biquad cascade",
        other_shapes=others, **k1,
    ))

    # K2 at the echo remover's chain reads: sf rows (W = 19, F = 512) in the
    # row, the blocks rows (W = 15, F = 384) beside it, and default_48k's
    # (one render channel, two bands, B = 4096: F = 256 and 128).
    def k2_case(W, F, B=B, rng=rng):
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
        other_shapes={
            "blocks": k2_case(15, 384),
            "default_48k_sf": k2_case(19, 256, 4096,
                                      np.random.default_rng(SEED + 103)),
            "default_48k_blocks": k2_case(15, 128, 4096,
                                          np.random.default_rng(SEED + 104))},
        **k2))

    # K3 at the matched filter's shapes (5 filters of 512 taps, DS = 2448,
    # sub 16: the specialised form), the runtime-sub form beside it, and
    # default_48k's B = 4096.
    k3, (low, h0, y, got) = _k3_case(dev, rng, 512, 16)
    k3_main, (_, h0_m, y_m, got_m) = _k3_case(
        dev, np.random.default_rng(SEED + 102), 512, 16, 4096)
    rows.append(dict(
        name="matched_filter_nlms", route="cuda",
        source="webrtc_audio_processing_tpu_torch/csrc/matched_filter.cu",
        replaces="webrtc_audio_processing_tpu/ops/pallas_mf.py:31",
        library_ms=None, library_device_ms=None,
        library_note="none: no PyTorch call runs a per-sample NLMS",
        other_shapes={"taps256_sub8": _k3_case(
            dev, np.random.default_rng(SEED + 100), 256, 8)[0],
            "default_48k": k3_main}, **k3))

    # K4 at the winner filter's shapes (the specialised form), the general
    # form and default_48k's B = 4096 beside it.
    def winner(h0, y, got):
        return (got[4][:, 0].contiguous(), h0[:, 0].contiguous(),
                (got[1][:, 0] * 1.0).contiguous(), y)

    k4 = _k4_case(dev, *winner(h0, y, got), 4)
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
        other_shapes={"taps256_rate8": k4_256, "default_48k": _k4_case(
            dev, *winner(h0_m, y_m, got_m), 4)}, **k4))

    # K5 at the RNN-VAD's shapes: B = 2048 and default_48k's 4096, L = 864,
    # W = 480, with the int64 starts the pitch search gives it
    # (rnn_vad/features.py).
    def k5_case(B=B, rng=rng):
        buf = torch.from_numpy(
            rng.standard_normal((B, 864)).astype(np.float32)).to(dev)
        start = torch.from_numpy(rng.integers(0, 385, B)).to(dev)
        w_k = cuda_window.take_windows_cuda(buf, start, 480)
        w_p = cuda_window.take_windows_plain(buf, start, 480)
        torch.cuda.synchronize()
        err = float((w_k - w_p).abs().max())
        if not torch.equal(w_k, w_p):
            raise AssertionError(f"K5 differs from its twin: max |diff| "
                                 f"{err}")
        idx = start.long()[:, None] + torch.arange(480, device=dev)
        bound, by = _bound_ms(2 * B * 480 * 4)
        return dict(
            max_abs_err=err,
            **_times(lambda: cuda_window.take_windows_cuda(buf, start, 480),
                     200, 50),
            plain_ms=_event_ms(
                lambda: cuda_window.take_windows_plain(buf, start, 480), 200),
            library_ms=_event_ms(lambda: torch.gather(buf, 1, idx), 200),
            library_device_ms=_graph_ms(lambda: torch.gather(buf, 1, idx),
                                        50),
            bound_ms=bound, bound_by=by, shape=f"B={B} L=864 W=480")

    k5 = k5_case()
    rows.append(dict(
        name="take_windows", route="cuda",
        source="webrtc_audio_processing_tpu_torch/csrc/window.cu",
        replaces="webrtc_audio_processing_tpu/ops/pallas_window.py:21",
        library_note="torch.gather with a prebuilt index",
        other_shapes={"default_48k": k5_case(
            4096, np.random.default_rng(SEED + 105))}, **k5))

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
    rows.append(dict(
        name="agc1_limiter", route="cuda",
        source="webrtc_audio_processing_tpu_torch/csrc/agc1_limiter.cu",
        replaces=("webrtc_audio_processing_tpu/models/agc1/digital.py:397 "
                  "(lax.while_loop, not a Pallas kernel: port-only)"),
        library_ms=None, library_device_ms=None,
        library_note="none: no PyTorch call runs a data-dependent loop",
        **limiter_case(dev, np.random.default_rng(SEED + 108))))
    for r in rows:
        phase("kernel", **r)
    return rows


def limiter_case(dev, rng, N=4096):
    """AGC1's limiter at phase 11's rows (B = 4096, one channel): gains of
    the hybrid's 7 dB table and of the worst case over AGC1's range
    (tools/torch_agc1_limiter_worst.py: the fixed-digital 90 dB table's
    largest gain, 727 passes on an envelope of 2^25) on a quarter of the
    rows, envelopes up to full scale."""
    from webrtc_audio_processing_tpu_torch.models.agc1 import digital

    table = digital.calculate_gain_table(7, 2, True, 7)
    worst = int(digital.calculate_gain_table(90, 0, True, 90).max())
    gains = rng.choice(table, (N, 11)).astype(np.int64)
    env = rng.integers(0, 2**30, (N, 10))
    gains[: N // 4, 1:] = worst
    env[: N // 4] = 2**25 - 1
    gains = torch.from_numpy(gains.astype(np.int32)).to(dev)
    env = torch.from_numpy(env.astype(np.int32)).to(dev)
    return limiter_times(dev, gains, env)


def limiter_times(dev, gains, env):
    """The limiter kernel on ``gains`` (N, 11) and ``env`` (N, 10) int32 on
    the card: bit-equal to the twin, its times and bound. The bound is
    latency: the bytes (0.5 MB at N = 4096) take 0.16 us, the longest
    row's chain of passes (~20 dependent integer ops each) far longer; the
    passes the data needs are counted for it."""
    from webrtc_audio_processing_tpu_torch.ops import cuda_agc1_limiter

    N = gains.shape[0]
    got = cuda_agc1_limiter.limit_cuda(gains, env)
    want = cuda_agc1_limiter.limit_plain(gains, env)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"the AGC1 limiter differs from its twin: {err}")
    n = cuda_agc1_limiter.passes(gains.cpu(), env.cpu())
    ops_per_pass = 20
    bound, by = _bound_ms(32 * 4 * N, n_ops=ops_per_pass * int(n.sum()),
                          chain_s=ops_per_pass * int(n.max()) * DEP_OP_S)
    return dict(
        max_abs_err=err,
        **_times(lambda: cuda_agc1_limiter.limit_cuda(gains, env), 200, 50),
        plain_ms=_event_ms(lambda: cuda_agc1_limiter.limit_plain(gains, env),
                           2),
        bound_ms=bound, bound_by=by, passes_max=int(n.max()),
        passes_mean=float(n.float().mean()),
        shape=f"N={N} (11 gains, 10 envelopes a row)")


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
    streams = list(streams)
    render = np.empty((len(streams), n, channels), np.float32)
    capture = np.empty((len(streams), n, channels), np.float32)
    paths = ((0.4, 0.15, 5), (0.35, 0.12, 9))[:channels]

    def one(i):
        rng = np.random.default_rng([seed, streams[i]])
        p1, p2 = rng.uniform(0, 2 * np.pi, 2)
        burst = (np.sin(2 * np.pi * 2.3 * t + p1) > -0.2).astype(np.float32)
        level = 0.15 + 0.85 * np.abs(np.sin(2 * np.pi * 0.4 * t + p2))
        far = rng.standard_normal(n, dtype=np.float32) * (0.2 * burst * level)
        for ch, (direct, late, lag) in enumerate(paths):
            render[i, :, ch] = far
            capture[i, :, ch] = direct * far + late * np.roll(far, lag)
        capture[i] += 0.01 * rng.standard_normal((n, channels),
                                                 dtype=np.float32)

    # Streams in threads (numpy's fills and ufuncs release the GIL): the
    # main path's 4096 streams take ~70 s of the host one by one.
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        list(pool.map(one, range(len(streams))))
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
        cuda_agc1_limiter,
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
            "subtractor_pair": cuda_subtractor,
            "agc1_limiter": cuda_agc1_limiter}


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
# The bench's modes and the APM's own default pipeline (``Pipeline()``:
# internal rate capped at 32 kHz, multichannel capture and render off) at
# 48 kHz stereo: processed mono at 32 kHz in two bands, resampled in and
# out of the AudioBuffer.
MODES = {**BENCH_MODES, "default_48k": (48000, 2, 32000)}


def aec3_config(cfg_mod, mode="48k_stereo"):
    """``bench.build_step``'s configuration (bench.py:53-78) for ``mode``;
    ``default_48k`` keeps ``Config()``'s own ``Pipeline()``."""
    _, channels, internal = MODES[mode]
    pipeline = (cfg_mod.Pipeline() if mode == "default_48k" else
                cfg_mod.Pipeline(multi_channel_capture=channels > 1,
                                 multi_channel_render=channels > 1,
                                 maximum_internal_processing_rate=internal))
    return cfg_mod.Config().replace(
        pipeline=pipeline,
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
    rate, channels, _ = MODES[mode]
    return apm.ApmGeometry.create(
        aec3_config(cfg_mod, mode), rate, channels, render_input_rate=rate,
        num_render_channels=channels,
        aec3_stereo_content=mode != "default_48k" and channels > 1,
        aec3_pair_kernel=pair_kernel)


def expected_aec3_launches(geo, n_frames):
    """The launches ``n_frames`` frames of an AEC3 geometry imply. K1 per
    frame: the HPF (full band or band 0) once, the PostFilter once (48 kHz
    processing only), each QMF direction twice (one cascade a branch:
    capture analysis and synthesis at 32 kHz, render analysis and
    synthesis when the render is processed at 32 kHz), and per frame pair 5
    render and 5 capture decimations (one launch for both cascades); K2
    the echo remover's four chain reads per frame; K3 and K4 one per
    capture block; K5 one per frame (AGC2's VAD); K6 one per frame on the
    pair-kernel path. With AGC1 its limiter once a frame, and with the
    hybrid manager K1 once a frame for the analytics VAD's pole-zero HPF
    and nine more on the frames of its phase 2 (every third, from frame 2:
    five in the pre-filter bank, four in the pitch analysis)."""
    pairs, odd = divmod(n_frames, 2)
    blocks = 5 * pairs + 2 * odd
    qmf_directions = 2 * ((geo.capture_processing_rate == 32000)
                          + (geo.render_processing_rate == 32000))
    per_frame = (geo.hpf_enabled + geo.post_filter_enabled
                 + 2 * qmf_directions)
    vad = n_frames + 9 * (n_frames // 3) if geo.agc1_hybrid else 0
    return {"biquad_cascade": per_frame * n_frames + 2 * blocks + vad,
            "span_gather": 4 * n_frames,
            "matched_filter_nlms": blocks, "pre_echo_inst": blocks,
            "take_windows": n_frames if geo.config.gain_controller2.enabled
            else 0,
            "subtractor_pair": n_frames if geo.aec3.pair_kernel else 0,
            "agc1_limiter": (n_frames if geo.config.gain_controller1.enabled
                             else 0)}


@functools.lru_cache(maxsize=1)
def _scene_streams(rate, channels, batch):
    return echo_scene(AEC3_FRAMES, SEED, range(batch), rate, channels)


def _scene(mode, batch):
    """The scene's first ``batch`` streams. The paths at one rate and
    channel count share one scene of the most streams any of them runs
    (a stream's signals depend only on its index), made once."""
    rate, channels, _ = MODES[mode]
    most = max(p.batch for p in AEC3_PATHS
               if MODES[p.mode][:2] == (rate, channels))
    render, capture = _scene_streams(rate, channels, max(most, batch))
    return render[:batch], capture[:batch]


def aec3_path_phase(dev, smi, path):
    from webrtc_audio_processing_tpu_torch import apm, bench

    rate, channels, _ = MODES[path.mode]
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
    want = expected_aec3_launches(geo, AEC3_FRAMES)
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

    frame = MODES[path.mode][0] // 100
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
    launches (captured per pair x replays) and the real-time streams."""
    from webrtc_audio_processing_tpu_torch import apm, bench, step_graph

    rate, channels, _ = MODES[path.mode]
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
    want = expected_aec3_launches(geo, 2)
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
    return launches, Bp * min(10.0 / host_ms, 1.0)


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


# --------------------------------------------- the API and the engine

# 200 frames (2 s): the API and the direct path run eagerly at B = 1, ~0.5
# s a frame between them; the delay has locked and the ERLE over the last
# third is far above the bar by then (25.3 dB on the CPU).
API_FRAMES = 200
API_PROFILED = range(145, 148)  # the first is the profiler's warm-up
ENGINE_BATCH = 4096
ENGINE_FRAMES = 120
ENGINE_QUEUE = 16
ENGINE_MISS_FRAMES = 40
ENGINE_PRODUCERS = 8


def api_direct_outputs(geo, dev, render, capture, n_frames):
    """``apm.process_stream_pair`` at B = 1 from ``init_state`` on the
    frames ``api.AudioProcessing`` processes from the same (n, channels)
    signals: frame 0's render is silence the echo detector is not fed
    (the API's lazy initialization drops the render queued before it),
    every later frame its own. Returns (outputs (n_frames, frame, ch),
    delays)."""
    from webrtc_audio_processing_tpu_torch import apm

    frame = geo.capture_input_rate // 100
    state = apm.init_state(geo, 1, dev)
    outs, delays = [], []
    for f in range(n_frames):
        sl = slice(f * frame, (f + 1) * frame)
        ren = render[sl] if f else np.zeros_like(render[sl])
        ren = torch.from_numpy(ren)[None].to(dev)
        state, out, _, stats = apm.process_stream_pair(
            geo, state, torch.from_numpy(capture[sl])[None].to(dev), ren,
            render_valid=None if f else False)
        outs.append(out[0])
        delays.append(stats["delay_ms"][0])
    return (torch.stack(outs).cpu().numpy(),
            torch.stack(delays).cpu().numpy().tolist())


def api_phase(dev, smi):
    """Phase 9: one ``api.AudioProcessing`` on the card, ``Config()``'s
    pipeline with HPF, AEC3, NS and AGC2 at 48 kHz stereo, fed stream 0
    of ``default_48k``'s scene (reverse, then capture, each frame); held
    bit for bit to ``apm.process_stream_pair`` at B = 1. Returns the
    launches of its run."""
    from webrtc_audio_processing_tpu_torch import api, bench, config as cfg_mod

    rate, channels, _ = MODES["default_48k"]
    frame = rate // 100
    render, capture = (x[0, :API_FRAMES * frame]
                       for x in _scene("default_48k", 1))
    ap = api.AudioProcessing(aec3_config(cfg_mod, "default_48k"), device=dev)
    outs, delays, kernels = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def frame_call(f):
        sl = slice(f * frame, (f + 1) * frame)
        err_r, _ = ap.process_reverse_stream(render[sl], rate)
        err, out = ap.process_stream(capture[sl], rate)
        if err_r or err:
            raise AssertionError(f"API error {err_r}, {err} at frame {f}")
        outs.append(out)
        delays.append(ap.get_statistics().delay_ms)

    first_timed = API_PROFILED[-1] + 1
    _reset_counts()
    for f in range(API_FRAMES):
        if f == API_PROFILED[0]:
            kernels.append(bench.device_kernels(
                [lambda f=f: frame_call(f)],
                [lambda g=g: frame_call(g) for g in API_PROFILED[1:]]))
        elif f not in API_PROFILED:
            if f == first_timed:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            frame_call(f)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1000.0 / (API_FRAMES - first_timed)
    launches = _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    geo = ap._geo
    want = expected_aec3_launches(geo, API_FRAMES)
    got = np.stack(outs)
    t1 = time.perf_counter()
    direct, direct_delay = api_direct_outputs(geo, dev, render, capture,
                                              API_FRAMES)
    direct_s = time.perf_counter() - t1
    differ = [f for f in range(API_FRAMES)
              if not np.array_equal(got[f], direct[f])]
    erle = erle_db(capture[None], render[None], got.reshape(1, -1, channels),
                   frame)
    # Host ms per frame (reverse + capture) over the frames after the
    # profiled ones.
    phase("api_48k_stereo", frames=API_FRAMES, streams=1,
          timed_frames=API_FRAMES - first_timed, host_ms_per_frame=host_ms,
          direct_ms_per_frame=direct_s * 1000.0 / API_FRAMES,
          device_kernels_per_frame=kernels[0],
          realtime_streams=min(10.0 / host_ms, 1.0),
          launches=launches, expected_launches=want,
          bit_equal_to_direct=not differ,
          frames_differing=len(differ),
          first_frame_differing=differ[0] if differ else None,
          delay_ms_equal=delays == direct_delay,
          last_delay_ms=delays[-1], erle_db=float(erle[0]),
          peak_mem_gb=peak_gb, card=smi)
    if differ:
        raise AssertionError(f"the API differs from process_stream_pair on "
                             f"{len(differ)} frames from frame {differ[0]}")
    if delays != direct_delay:
        raise AssertionError("get_statistics().delay_ms differs from the "
                             "direct path's delay")
    if launches != want:
        raise AssertionError(f"API launches {launches}, expected {want}")
    if not erle[0] > ERLE_BAR_DB:
        raise AssertionError(f"API ERLE {erle} dB not above {ERLE_BAR_DB}")
    return launches


def _push_all(plane, render, capture, frames, streams, frame):
    """Producer threads (one per slice of the streams, each stream's
    queues fed by one thread) push ``frames`` of every stream in
    ``streams``; returns the seconds they took."""
    parts = np.array_split(np.asarray(streams), ENGINE_PRODUCERS)

    def produce(part):
        for s in part:
            for f in frames:
                sl = slice(f * frame, (f + 1) * frame)
                if not (plane.push_capture(s, capture[s, sl])
                        and plane.push_render(s, render[s, sl])):
                    raise AssertionError(f"stream {s} queue full")

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(ENGINE_PRODUCERS) as pool:
        list(pool.map(produce, parts))
    return time.perf_counter() - t0


def engine_phase(dev, smi, eager_out, graphed_streams):
    """Phase 10: ``runtime.StreamingPlane`` + ``BatchEngine`` on the APM
    step captured as one graph per frame parity (``apm_step_fn``), B =
    4096 streams of ``default_48k``. The first ``ENGINE_FRAMES`` frames of
    phase 4's scene go through the plane, producers pushing up to the
    queues' capacity before the engine steps; the checked streams' outputs
    must be phase 4's eager outputs ``eager_out`` bit for bit. Then
    ``ENGINE_MISS_FRAMES`` frames in which every 8th stream misses every
    5th frame, against an eager ``process_stream_pair`` fed zeros in
    those rows. Returns the launches: captured per frame pair x pairs."""
    from webrtc_audio_processing_tpu_torch import apm, step_graph
    from webrtc_audio_processing_tpu_torch.runtime import (
        BatchEngine,
        StreamingPlane,
        apm_step_fn,
    )

    rate, channels, _ = MODES["default_48k"]
    frame, Bp = rate // 100, ENGINE_BATCH
    render, capture = _scene("default_48k", Bp)
    check = [0, Bp - 1]
    geo = aec3_geometry("default_48k", False)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reserved = torch.cuda.memory_reserved()
    _reset_counts()
    t0 = time.perf_counter()
    step_fn, state, graphs = apm_step_fn(geo, Bp, dev)
    build_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    state_gb = sum(t.nbytes for t in step_graph._tensor_leaves(state)) / 1e9
    # What the graphs' private pool holds beyond the state they own.
    pool_gb = (torch.cuda.memory_reserved() - reserved) / 1e9 - state_gb
    # The warm-up and the capture each run one even and one odd frame.
    captured = {k: v // 2 for k, v in _counts().items()}
    want = expected_aec3_launches(geo, 2)
    if _counts() != {k: 2 * v for k, v in want.items()}:
        raise AssertionError(f"engine graphs launched {_counts()}, expected "
                             f"twice {want}")

    plane = StreamingPlane(Bp, frame, channels, channels, ENGINE_QUEUE)
    engine = BatchEngine(plane, step_fn, state, device=dev, sync_stages=True)
    got = {s: [] for s in check}
    push_s = step_s = pop_s = 0.0
    for c0 in range(0, ENGINE_FRAMES, ENGINE_QUEUE):
        chunk = range(c0, min(c0 + ENGINE_QUEUE, ENGINE_FRAMES))
        push_s += _push_all(plane, render, capture, chunk, range(Bp), frame)
        for _ in chunk:
            t1 = time.perf_counter()
            fed = engine.step()
            step_s += time.perf_counter() - t1
            if fed != Bp:
                raise AssertionError(f"the engine fed {fed} streams")
        t1 = time.perf_counter()
        for s in range(Bp):
            for _ in chunk:
                out = plane.pop_output(s)
                if s in got:
                    got[s].append(out)
        pop_s += time.perf_counter() - t1
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    got_out = np.stack([np.concatenate(got[s]) for s in check])
    differ = [f for f in range(ENGINE_FRAMES) if not np.array_equal(
        got_out[:, f * frame:(f + 1) * frame],
        eager_out[:, f * frame:(f + 1) * frame])]
    processed = {plane.frames_processed(s) for s in range(Bp)}
    dropped = sum(plane.dropped(s) for s in range(Bp))
    sec = {k: v * 1000.0 / ENGINE_FRAMES for k, v in engine.seconds.items()}
    t_step = step_s * 1000.0 / ENGINE_FRAMES

    # Missed frames: the same graphs from a fresh state, one frame pushed
    # and stepped at a time; every 8th stream misses every 5th frame.
    step_graph.copy_into(graphs.state, apm.init_state(geo, Bp, dev))
    graphs.state.frame_counter = 0
    plane2 = StreamingPlane(Bp, frame, channels, channels, ENGINE_QUEUE)
    engine2 = BatchEngine(plane2, step_fn, graphs.state, device=dev)
    eager = apm.init_state(geo, Bp, dev)
    miss_rows = np.arange(Bp) % 8 == 0
    rows = torch.from_numpy(miss_rows).to(dev)[:, None, None]
    m_check = [0, Bp - 1]  # stream 0 misses, stream 4095 does not
    m_got = {s: [] for s in m_check}
    m_want = {s: [] for s in m_check}
    for f in range(ENGINE_MISS_FRAMES):
        missed = f % 5 == 0
        fed = np.flatnonzero(~miss_rows) if missed else np.arange(Bp)
        _push_all(plane2, render, capture, [f], fed, frame)
        if engine2.step() != fed.size:
            raise AssertionError("the engine fed the wrong streams")
        sl = slice(f * frame, (f + 1) * frame)
        cap = torch.from_numpy(capture[:, sl]).to(dev)
        ren = torch.from_numpy(render[:, sl]).to(dev)
        if missed:
            cap = torch.where(rows, 0.0, cap)
            ren = torch.where(rows, 0.0, ren)
        eager, out, _, _ = apm.process_stream_pair(geo, eager, cap, ren)
        for s in m_check:
            if not (missed and miss_rows[s]):
                m_want[s].append(out[s].cpu().numpy())
        for s in range(Bp):
            out = plane2.pop_output(s)
            if s in m_got and out is not None:
                m_got[s].append(out)
    m_equal = {s: len(m_got[s]) == len(m_want[s]) and all(
        np.array_equal(g, w) for g, w in zip(m_got[s], m_want[s]))
        for s in m_check}
    m_processed = {plane2.frames_processed(s) for s in np.flatnonzero(
        miss_rows)}, {plane2.frames_processed(s) for s in np.flatnonzero(
            ~miss_rows)}
    m_dropped = sum(plane2.dropped(s) for s in range(Bp))
    pairs = (ENGINE_FRAMES + ENGINE_MISS_FRAMES) // 2
    launches = {k: v * pairs for k, v in captured.items()}
    phase("engine_default_48k", streams=Bp, frames=ENGINE_FRAMES,
          queue_capacity=ENGINE_QUEUE, producers=ENGINE_PRODUCERS,
          push_ms_per_frame=push_s * 1000.0 / ENGINE_FRAMES,
          collect_ms_per_frame=sec["collect"],
          h2d_and_replay_ms_per_frame=sec["step"],
          d2h_and_distribute_ms_per_frame=sec["out"],
          engine_step_ms_per_frame=t_step,
          pop_ms_per_frame=pop_s * 1000.0 / ENGINE_FRAMES,
          realtime_streams=Bp * min(10.0 / t_step, 1.0),
          graphed_realtime_streams=graphed_streams,
          build_and_capture_seconds=build_s,
          capture_seconds=graphs.capture_seconds,
          launches_captured_per_pair=captured, launches=launches,
          bit_equal_to_eager=not differ,
          frames_differing_from_eager=len(differ),
          first_frame_differing=differ[0] if differ else None,
          frames_processed=sorted(processed), dropped=dropped,
          missed_frames_bit_equal=m_equal,
          missed_frames_processed=[sorted(x) for x in m_processed],
          missed_frames_dropped=m_dropped,
          peak_mem_gb=peak_gb, state_gb=state_gb, graph_pool_gb=pool_gb,
          card=smi)
    if captured != want:
        raise AssertionError(f"engine captured {captured} a pair, expected "
                             f"{want}")
    if differ:
        raise AssertionError(f"engine outputs differ from eager on "
                             f"{len(differ)} frames from {differ[0]}")
    if processed != {ENGINE_FRAMES} or dropped:
        raise AssertionError(f"frames processed {processed}, dropped "
                             f"{dropped}")
    if not all(m_equal.values()):
        raise AssertionError(f"missed-frame run differs: {m_equal}")
    if m_processed != ({ENGINE_MISS_FRAMES - ENGINE_MISS_FRAMES // 5},
                       {ENGINE_MISS_FRAMES}) or m_dropped:
        raise AssertionError(f"missed-frame counts {m_processed}, dropped "
                             f"{m_dropped}")
    return launches


# ------------------------------------------------- AECM, the fixed profile

AECM_BATCH = 4096
# 6 s, tests/test_aecm_apm.py's length: AECM's channel is still in its
# startup convergence at 3 s (tot_count < 2 CONV_LEN blocks), where this
# scene's ERLE over the last third is -1.4 to 4.9 dB on the echo-only
# streams (the port on the CPU, 12 streams: tools/torch_aecm_erle.py);
# over 4-6 s it is 54-76 dB.
AECM_FRAMES = 600
AECM_EAGER = 60  # frames run eagerly, then held to the graph
# The stream delay every stream reports: the smallest echo delay. AECM
# fetches the far end that late and searches later lags only, so an echo
# earlier than the reported delay is acausal to it: at 30 ms reported the
# 20 ms streams keep 8.2-9.5 dB (the same CPU runs).
AECM_DELAY_MS = 20
AECM_ECHO_DELAYS_MS = (20, 30, 50)  # the echo's true delay, by stream % 3
AECM_CHECK = (0, 1, 4094, 4095)  # even: echo only; odd: echo and speech
AECM_CPU_PAIR = 280  # the pair from frame 560, rerun on the CPU
AECM_CORE_FRAME = 400  # AECM alone, card against CPU, from this frame
AECM_CORE_STREAMS = 8
AECM_CORE_FRAMES = 10
AECM_ERLE_BAR_DB = 8.0  # tests/test_aecm_apm.py:44
# The bar holds on the checked echo-only streams, as phases 7 and 11 hold
# theirs, and on this share of all the echo-only streams: AECM itself lets
# a few streams' echo through for a few seconds after its startup phases
# change (at 512 and 1024 blocks) before it settles again, in the JAX
# package as in the port (the same ERLE to 0.01 dB on the CPU:
# tests/torch_aecm_erle_streams.py).
AECM_ERLE_SHARE = 0.99
AECM_CPU_RTOL = RTOL_RMS
AECM_8K_BATCH = 64
AECM_8K_FRAMES = 40


def aecm_config(cfg_mod):
    """The reference's fixed profile, WEBRTC_AUDIOPROC_FIXED_PROFILE (its
    Android build; audio_processing_unittest.cc:135-141, as
    tools/apm_conformance.py:75-88 sets it with mobile=True): AECM in
    mobile mode, AGC1 adaptive digital without the analog controller, NS
    and the HPF."""
    return cfg_mod.Config().replace(
        pipeline=cfg_mod.Pipeline(maximum_internal_processing_rate=48000),
        echo_canceller=cfg_mod.EchoCanceller(enabled=True, mobile_mode=True),
        gain_controller1=cfg_mod.GainController1(
            enabled=True, mode=cfg_mod.Agc1Mode.ADAPTIVE_DIGITAL,
            analog_gain_controller=cfg_mod.AnalogGainController(
                enabled=False)),
        noise_suppression=cfg_mod.NoiseSuppression(enabled=True),
        high_pass_filter=cfg_mod.HighPassFilter(enabled=True))


def aecm_geometry(rate):
    """The fixed profile's APM geometry at ``rate``, mono."""
    from webrtc_audio_processing_tpu_torch import apm, config as cfg_mod

    return apm.ApmGeometry.create(aecm_config(cfg_mod), rate, 1,
                                  render_input_rate=rate,
                                  num_render_channels=1)


def aecm_scene(n_frames, rate, streams):
    """(len(streams), n, 1) float32 render and capture: per stream s,
    tests/test_aecm_apm.py:11-15's speech-like far end (noise from the seed
    (SEED, s) under 2.7 Hz bursts with >10 dB level swings), its echo
    ``AECM_ECHO_DELAYS_MS[s % 3]`` late with tests/test_aecm.py's smear
    (0.5, 0.2, 0.1), and on the odd streams a voiced near end at 0.1 of
    full scale (``voiced_near_end``)."""
    n = n_frames * rate // 100
    tt = np.arange(n) / rate
    env = ((np.sin(2 * np.pi * 2.7 * tt) > -0.3)
           * (0.08 + 0.92 * np.abs(np.sin(2 * np.pi * 0.31 * tt))))
    streams = np.asarray(streams)
    far = np.empty((len(streams), n), np.float32)
    for i, s in enumerate(streams):
        far[i] = np.random.default_rng((SEED, int(s))).standard_normal(
            n, dtype=np.float32)
    far *= (0.28 * env).astype(np.float32)
    near = np.empty_like(far)
    for k, d in enumerate(AECM_ECHO_DELAYS_MS):
        rows = streams % 3 == k
        fd = np.roll(far[rows], d * rate // 1000, axis=1)
        near[rows] = (0.5 * fd + 0.2 * np.roll(fd, 1, axis=1)
                      + 0.1 * np.roll(fd, 2, axis=1))
    near[streams % 2 == 1] += voiced_near_end(n, rate, SEED)
    return far[..., None], near[..., None]


def expected_aecm_launches(geo, n_frames):
    """The launches ``n_frames`` frames of the mobile path imply: K1 for
    the HPF once a frame, and for each QMF direction twice (at 32 kHz);
    AGC1's limiter once a frame."""
    qmf_directions = 2 * ((geo.capture_processing_rate == 32000)
                          + (geo.render_processing_rate == 32000))
    want = {k: 0 for k in _kernel_modules()}
    want.update(biquad_cascade=(geo.hpf_enabled + 2 * qmf_directions)
                * n_frames, agc1_limiter=n_frames)
    return want


def _int_leaves(state) -> dict:
    """AECM's and AGC1's integer and bool leaves, on their device."""
    import webrtc_audio_processing_tpu_torch.step_graph as sg

    out = {}
    for name in ("aecm", "agc1"):
        for i, leaf in enumerate(sg._tensor_leaves(getattr(state, name))):
            if not leaf.dtype.is_floating_point:
                out[f"{name}.{i}"] = leaf.clone()
    return out


def _erle_active_db(near, far, out):
    """tests/test_aecm_apm.py:36-41's ERLE per stream over the far end's
    active samples: near, far, out (S, n) tensors."""
    active = (far.abs() > 1e-4).double()
    e_in = (near.double() ** 2 * active).sum(1) / active.sum(1)
    e_out = (out.double() ** 2 * active).sum(1) / active.sum(1)
    return 10.0 * torch.log10((e_in + 1e-12) / (e_out + 1e-12))


def aecm_core_check(dev, card_state, rows, render, capture, geo):
    """AECM alone, card against CPU, bit for bit: from the card's AECM
    state of streams ``rows`` (``card_state``, (S, 1, ...) leaves),
    buffer_farend and process_frame on the card and on the CPU, fed the
    same int16 frames (the scene's, from AECM_CORE_FRAME) for
    AECM_CORE_FRAMES frames. Returns (outputs equal on every frame, the
    leaves that differ at the end, the streams past startup)."""
    from webrtc_audio_processing_tpu_torch import apm
    from webrtc_audio_processing_tpu_torch.models.agc1 import gain_control
    from webrtc_audio_processing_tpu_torch.ops import audio_util

    S = len(rows)
    card = gain_control.flatten_channels(card_state)
    cpu = gain_control.flatten_channels(
        select_streams(card_state, torch.arange(S, device=dev), "cpu"))
    F = geo.capture_input_rate // 100
    delay = torch.full((S,), AECM_DELAY_MS, dtype=torch.int32)
    outs_equal = []
    for f in range(AECM_CORE_FRAME, AECM_CORE_FRAME + AECM_CORE_FRAMES):
        sl = slice(f * F, (f + 1) * F)
        far, near = (audio_util.float_to_s16(torch.from_numpy(
            x[rows, sl, 0])).to(torch.int32) for x in (render, capture))
        card, y_card = ecm_buffer_and_process(
            geo.aecm, card, far.to(dev), near.to(dev), delay.to(dev))
        cpu, y_cpu = ecm_buffer_and_process(geo.aecm, cpu, far, near, delay)
        outs_equal.append(torch.equal(y_card.cpu(), y_cpu))
    got, want = apm.state_to_numpy(card), apm.state_to_numpy(cpu)
    leaves = sorted(k for k in want if not np.array_equal(got[k], want[k]))
    return all(outs_equal), leaves, int((~cpu.ec_startup).sum())


def ecm_buffer_and_process(aecm_geo, st, far, near, delay):
    """One frame of AECM alone: the far end buffered, the near end
    processed. Returns (state, out)."""
    from webrtc_audio_processing_tpu_torch.models.aecm import (
        echo_control_mobile as ecm,
    )

    st = ecm.buffer_farend(st, far)
    return ecm.process_frame(aecm_geo, st, near, delay)


def aecm_fixed_phase(dev, smi, main_streams):
    """Phase 12: ``aecm_fixed_16k``, eager then graphed; see the module
    docstring. ``main_streams``: phase 7's graphed ``default_48k``
    real-time streams, printed beside. Returns (the eager run's launches,
    the graphed run's: captured per pair x replays, AGC1's limiter inputs
    of one eager frame)."""
    from webrtc_audio_processing_tpu_torch import apm, bench, step_graph
    from webrtc_audio_processing_tpu_torch.ops import cuda_agc1_limiter

    rate, frame, Bp = 16000, 160, AECM_BATCH
    geo = aecm_geometry(rate)
    if geo.aecm is None or geo.aec3 is not None:
        raise AssertionError("the fixed profile runs AECM, not AEC3")
    period = apm.parity_period(geo)
    t0 = time.perf_counter()
    render, capture = aecm_scene(AECM_FRAMES, rate, range(Bp))
    ren_dev = torch.from_numpy(render).to(dev)
    cap_dev = torch.from_numpy(capture).to(dev)
    setup_s = time.perf_counter() - t0
    idx = torch.tensor(AECM_CHECK, device=dev)
    core_rows = np.arange(AECM_CORE_STREAMS) * (Bp // AECM_CORE_STREAMS)
    core_rows_dev = torch.from_numpy(core_rows).to(dev)
    rec = "agc1_recommended_level"
    delay = torch.full((Bp,), AECM_DELAY_MS, dtype=torch.int32, device=dev)

    def frames(p):
        f0, f1 = (slice(f * frame, (f + 1) * frame)
                  for f in (2 * p, 2 * p + 1))
        return ren_dev[:, f0], cap_dev[:, f0], ren_dev[:, f1], cap_dev[:, f1]

    # AGC1's limiter inputs on this path's own data: one eager frame's.
    limiter_inputs = []
    limit_cuda = cuda_agc1_limiter.limit_cuda

    def keep_inputs(gains, env):
        if not limiter_inputs:
            limiter_inputs.append((gains.clone(), env.clone()))
        return limit_cuda(gains, env)

    # Eager: the pair body itself, every stream's outputs kept.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = apm.init_state(geo, Bp)
    e_outs = []
    _reset_counts()
    t1 = time.perf_counter()
    for p in range(AECM_EAGER // 2):
        if p == AECM_EAGER // 2 - 1:
            cuda_agc1_limiter.limit_cuda = keep_inputs
        try:
            pair_outs = step_graph.step_pair(geo, state, *frames(p),
                                             delay=delay)
        finally:
            cuda_agc1_limiter.limit_cuda = limit_cuda
        e_outs += [(out.clone(), stats[rec].clone())
                   for out, _, stats in pair_outs]
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t1) * 1000.0 / AECM_EAGER
    eager_launches = _counts()
    want = expected_aecm_launches(geo, AECM_EAGER)
    if eager_launches != want:
        raise AssertionError(f"aecm_fixed_16k launches {eager_launches}, "
                             f"expected {want}")
    eager_ints = _int_leaves(state)
    del state

    # Graphed from init_state: the pair graphs over one state.
    graph = step_graph.PairGraph(geo, apm.init_state(geo, Bp))
    graph.delay.fill_(AECM_DELAY_MS)
    reserved = torch.cuda.memory_reserved()
    _reset_counts()
    graph.capture()
    captured = _counts()
    pool_gb = (torch.cuda.memory_reserved() - reserved) / 1e9
    want = expected_aecm_launches(geo, period)
    if captured != want:
        raise AssertionError(f"aecm_fixed_16k captured {captured} launches "
                             f"a period, expected {want}")
    replays = AECM_FRAMES // 2
    first_timed = replays - AEC3_TIMED // 2
    timer_start = torch.cuda.Event(enable_timing=True)
    timer_end = torch.cuda.Event(enable_timing=True)
    g_outs, tail_outs, finite = [], [], []
    syncs = graph_ints = core_state = None
    for p in range(replays):
        if p == AECM_EAGER // 2:
            graph_ints = _int_leaves(graph.state)
        if p == AECM_CORE_FRAME // 2:
            core_state = select_streams(graph.state.aecm, core_rows_dev, dev)
        if p == AECM_CPU_PAIR:
            before = select_streams(graph.state, idx, "cpu")
        if p == first_timed:
            torch.cuda.synchronize()
            host_t0 = time.perf_counter()
            timer_start.record()
        if p == first_timed - 1:
            out_pair = []
            syncs = _sync_count(lambda: out_pair.append(
                graph.replay(*frames(p))))
            pair_outs = out_pair[0]
        else:
            pair_outs = graph.replay(*frames(p))
        if p < AECM_EAGER // 2:
            g_outs += [(out.clone(), stats[rec].clone())
                       for out, _, stats in pair_outs]
        if 2 * p >= AECM_FRAMES - AECM_FRAMES // 3:
            tail_outs += [out[0::2, :, 0].clone() for out, _, _ in pair_outs]
        finite.append(torch.stack([torch.isfinite(o).all()
                                   for o, _, _ in pair_outs]).all())
        if p == AECM_CPU_PAIR:
            card_pair = [(o[idx].cpu(), st[rec][idx].cpu())
                         for o, _, st in pair_outs]
    timer_end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - host_t0) * 1000.0 / AEC3_TIMED
    dev_ms = timer_start.elapsed_time(timer_end) / AEC3_TIMED
    kernels = bench.device_kernels(
        [lambda: graph.replay(*frames(replays - 1))],
        [lambda: graph.replay(*frames(replays - 1))] * 2) / 2
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not bool(torch.stack(finite).all()):
        raise AssertionError("non-finite output on aecm_fixed_16k")

    # The graph against the eager run: every stream's outputs and levels
    # on every frame, AECM's and AGC1's integer leaves after them.
    differ = [f for f, ((go, gl), (eo, el)) in enumerate(zip(g_outs, e_outs))
              if not (torch.equal(go, eo) and torch.equal(gl, el))]
    int_differ = sorted(k for k in eager_ints
                        if not torch.equal(eager_ints[k], graph_ints[k]))
    bit_equal = not differ and not int_differ

    # ERLE over the last third on the echo-only streams.
    n_tail = len(tail_outs) * frame
    out_tail = torch.cat(tail_outs, dim=1)
    erle = _erle_active_db(cap_dev[0::2, -n_tail:, 0],
                           ren_dev[0::2, -n_tail:, 0], out_tail).cpu()
    erle_checked = {s: float(erle[s // 2]) for s in AECM_CHECK if s % 2 == 0}
    erle_share = float((erle > AECM_ERLE_BAR_DB).double().mean())

    # AECM alone, card against CPU, from the card's state at frame 200.
    t2 = time.perf_counter()
    core_equal, core_leaves, core_enabled = aecm_core_check(
        dev, core_state, core_rows, render, capture, geo)
    del core_state
    # One pair on the CPU from the card's state before frame 280.
    cpu_outs = step_graph.step_pair(
        geo, before, *(x[idx].cpu() for x in frames(AECM_CPU_PAIR)),
        delay=delay[idx].cpu())
    cpu_rel = [float(np.sqrt(((c[0].numpy() - g.numpy()) ** 2).sum()
                             / max((g.numpy() ** 2).sum(), 1e-20)))
               for c, (g, _) in zip(cpu_outs, card_pair)]
    level_diff = max(int((c[2][rec] - gl).abs().max())
                     for c, (_, gl) in zip(cpu_outs, card_pair))
    cpu_s = time.perf_counter() - t2

    launches = {k: v * (replays // (period // 2))
                for k, v in captured.items()}
    main_ms = 10.0 * 4096 / main_streams
    phase("aecm_fixed_16k", streams=Bp, frames=AECM_FRAMES,
          stream_delay_ms=AECM_DELAY_MS,
          echo_delays_ms=list(AECM_ECHO_DELAYS_MS), period=period,
          eager_frames=AECM_EAGER, eager_ms_per_frame=eager_ms,
          eager_launches=eager_launches,
          launches_captured_per_period=captured, launches=launches,
          timed_frames=AEC3_TIMED, ms_per_frame=host_ms,
          event_ms_per_frame=dev_ms,
          realtime_streams=Bp * min(10.0 / host_ms, 1.0),
          device_kernels_per_frame=kernels,
          capture_seconds=graph.capture_seconds, peak_mem_gb=peak_gb,
          graph_pool_gb=pool_gb, host_syncs_per_replay=syncs[0],
          host_sync_sites=syncs[1], bit_equal_to_eager=bit_equal,
          frames_differing_from_eager=len(differ),
          int_leaves_differing=int_differ,
          erle_db_echo_only=dict(min=float(erle.min()),
                                 median=float(erle.median()),
                                 max=float(erle.max()),
                                 streams=int(erle.numel())),
          erle_db=dict(zip(map(str, erle_checked), erle_checked.values())),
          erle_share_above_bar=erle_share,
          erle_below_bar={str(2 * int(i)): float(erle[i]) for i in
                          torch.argsort(erle)[:20] if erle[i] <=
                          AECM_ERLE_BAR_DB},
          aecm_core_bit_equal=core_equal,
          aecm_core_leaves_differing=core_leaves,
          aecm_core_streams_enabled=core_enabled,
          cpu_pair_rel_rms=cpu_rel, cpu_pair_level_diff=level_diff,
          cpu_seconds=round(cpu_s, 3), input_seconds=round(setup_s, 3),
          default_48k_graphed_ms_per_frame=main_ms,
          default_48k_graphed_realtime_streams=main_streams, card=smi)
    if not bit_equal:
        raise AssertionError(
            f"aecm_fixed_16k graphed differs from eager: {len(differ)} "
            f"frames, integer leaves {int_differ}")
    if syncs[0]:
        raise AssertionError(f"{syncs[0]} host syncs in a replay: "
                             f"{syncs[1]}")
    if (min(erle_checked.values()) <= AECM_ERLE_BAR_DB
            or erle_share < AECM_ERLE_SHARE):
        raise AssertionError(
            f"ERLE on the checked echo-only streams {erle_checked} dB, "
            f"{erle_share:.4f} of the echo-only streams above "
            f"{AECM_ERLE_BAR_DB} dB (bars: every checked one, "
            f"{AECM_ERLE_SHARE} of all)")
    if not core_equal or core_leaves or not core_enabled:
        raise AssertionError(f"AECM card against CPU: outputs equal "
                             f"{core_equal}, leaves {core_leaves}, "
                             f"{core_enabled} streams past startup")
    if max(cpu_rel) > AECM_CPU_RTOL or level_diff > 1:
        raise AssertionError(f"the CPU pair differs from the card's: rel RMS "
                             f"{cpu_rel}, AGC1 level {level_diff}")
    return eager_launches, launches, limiter_inputs[0]


def aecm_8k_phase(dev, smi):
    """Phase 13: ``aecm_fixed_8k``, the fixed profile at 8 kHz mono (the
    capture processed at 16 kHz, AECM with it) at B = AECM_8K_BATCH for
    AECM_8K_FRAMES frames, eager then through the pair graphs from
    init_state: bit-equal on every frame. Returns (eager launches, graphed
    launches)."""
    from webrtc_audio_processing_tpu_torch import apm, step_graph

    rate, frame, Bp = 8000, 80, AECM_8K_BATCH
    geo = aecm_geometry(rate)
    period = apm.parity_period(geo)
    render, capture = aecm_scene(AECM_8K_FRAMES, rate, range(Bp))
    ren_dev = torch.from_numpy(render).to(dev)
    cap_dev = torch.from_numpy(capture).to(dev)
    delay = torch.full((Bp,), AECM_DELAY_MS, dtype=torch.int32, device=dev)

    def frames(p):
        f0, f1 = (slice(f * frame, (f + 1) * frame)
                  for f in (2 * p, 2 * p + 1))
        return ren_dev[:, f0], cap_dev[:, f0], ren_dev[:, f1], cap_dev[:, f1]

    state = apm.init_state(geo, Bp)
    _reset_counts()
    eager = []
    for p in range(AECM_8K_FRAMES // 2):
        eager += [out.clone() for out, _, _ in step_graph.step_pair(
            geo, state, *frames(p), delay=delay)]
    eager_launches = _counts()
    graph = step_graph.PairGraph(geo, apm.init_state(geo, Bp))
    graph.delay.fill_(AECM_DELAY_MS)
    _reset_counts()
    graph.capture()
    captured = _counts()
    got = []
    for p in range(AECM_8K_FRAMES // 2):
        got += [out.clone() for out, _, _ in graph.replay(*frames(p))]
    torch.cuda.synchronize()
    differ = [f for f, (g, e) in enumerate(zip(got, eager))
              if not torch.equal(g, e)]
    enabled = int((~graph.state.aecm.ec_startup).sum().item())
    launches = {k: v * (AECM_8K_FRAMES // period)
                for k, v in captured.items()}
    want = expected_aecm_launches(geo, AECM_8K_FRAMES)
    phase("aecm_fixed_8k", streams=Bp, frames=AECM_8K_FRAMES, period=period,
          aecm_rate_hz=geo.aecm.sample_rate_hz,
          bit_equal_to_eager=not differ,
          frames_differing_from_eager=len(differ),
          streams_past_startup=enabled, eager_launches=eager_launches,
          launches_captured_per_period=captured, launches=launches,
          card=smi)
    if differ:
        raise AssertionError(f"aecm_fixed_8k graphed differs from eager on "
                             f"{len(differ)} frames from {differ[0]}")
    if eager_launches != want or launches != want:
        raise AssertionError(f"aecm_fixed_8k launches {eager_launches} "
                             f"eager, {launches} graphed, expected {want}")
    if enabled != Bp:
        raise AssertionError(f"{Bp - enabled} streams still in AECM's "
                             f"startup after {AECM_8K_FRAMES} frames")
    return eager_launches, launches


# ----------------------------------------------------------- slice-1 path


# ------------------------------------------------------ AGC1 hybrid path

AGC1_BATCH = 4096
AGC1_FRAMES = 600  # the 300-frame scene twice
AGC1_EAGER = 60  # frames run eagerly, then held to the graph
AGC1_CHECK = (0, 1, 4094, 4095)  # even: echo only; odd: echo and speech
AGC1_CPU_PAIR = 280  # the pair from frame 560: the analytics VAD's phase 2
AGC1_START_LEVEL = 100
AGC1_CPU_RTOL = 1e-5
# The near end's level: 0.1 of full scale. At 0.02 (the level of
# tests/test_agc_manager_apm.py, which has no echo) and at 0.05 the
# hybrid AGC leaves stream 4095's level at 100 for 600 frames under the
# scene's residual echo, in the JAX package as in the port; at 0.1 both
# raise it from frame 137, equal on every frame (16 kHz mono on this
# scene's streams 4094 and 4095: tests/torch_agc1_voice_level.py).
AGC1_VOICE_AMP = 0.1


def agc1_geometry():
    """``Config()``'s pipeline at 48 kHz stereo with HPF, AEC3, NS and
    AGC1's defaults (adaptive analog through AgcManagerDirect), AGC2
    off."""
    from webrtc_audio_processing_tpu_torch import apm, config as cfg_mod

    c = cfg_mod.Config().replace(
        high_pass_filter=cfg_mod.HighPassFilter(enabled=True),
        echo_canceller=cfg_mod.EchoCanceller(enabled=True),
        noise_suppression=cfg_mod.NoiseSuppression(enabled=True),
        gain_controller1=cfg_mod.GainController1(enabled=True))
    return apm.ApmGeometry.create(c, 48000, 2, render_input_rate=48000,
                                  num_render_channels=2)


def voiced_near_end(n, rate, seed, amp=AGC1_VOICE_AMP):
    """tests/test_agc_manager_apm.py:11-19's ``_voiced`` (a pitch near
    120 Hz with harmonics and a slow envelope) at ``amp`` of full scale,
    its pitch's phase from ``seed``."""
    t = np.arange(n) / rate
    p0 = np.random.default_rng(seed).uniform(0, 2 * np.pi)
    f0 = 120 * (1 + 0.05 * np.sin(2 * np.pi * 3.0 * t + p0))
    ph = 2 * np.pi * np.cumsum(f0) / rate
    w = {1: 0.3, 2: 0.6, 3: 1.0, 4: 1.0, 5: 0.7}
    saw = sum(w.get(k, 1.0 / k) * np.sin(k * ph) for k in range(1, 10))
    x = saw * (0.7 + 0.3 * np.sin(2 * np.pi * 1.5 * t))
    return (amp * x / np.abs(x).max()).astype(np.float32)


def _agc1_leaves(state) -> dict:
    """The integer and bool leaves of AGC1's and the manager's state."""
    from webrtc_audio_processing_tpu_torch import apm

    out = {}
    for name in ("agc1", "agc_mgr"):
        for k, v in apm.state_to_numpy(getattr(state, name)).items():
            if v.dtype.kind in "iub":
                out[f"{name}.{k}"] = v
    return out


def agc1_hybrid_phase(dev, smi, main_streams):
    """Phase 11: ``agc1_hybrid_48k``, eager then graphed at period 6; see
    the module docstring. ``main_streams``: phase 7's graphed
    ``default_48k`` real-time streams, printed beside. Returns (the eager
    run's launches, the graphed run's: captured per period x periods)."""
    from webrtc_audio_processing_tpu_torch import apm, bench, step_graph

    rate, channels = 48000, 2
    frame, Bp = rate // 100, AGC1_BATCH
    geo = agc1_geometry()
    period = apm.parity_period(geo)
    if period != 6:
        raise AssertionError(f"the hybrid AGC's period is {period}, not 6")
    t0 = time.perf_counter()
    render, capture = _scene("default_48k", Bp)
    ren_dev = torch.from_numpy(render).to(dev)
    cap_dev = torch.from_numpy(capture).to(dev)
    voice = torch.from_numpy(voiced_near_end(capture.shape[1], rate,
                                             SEED)).to(dev)
    cap_dev[1::2] += voice[None, :, None]
    setup_s = time.perf_counter() - t0
    idx = torch.tensor(AGC1_CHECK, device=dev)
    rec = "agc1_recommended_level"

    def frames(p):
        """The pair p of the scene played in a loop."""
        p %= AEC3_FRAMES // 2
        f0, f1 = (slice(f * frame, (f + 1) * frame)
                  for f in (2 * p, 2 * p + 1))
        return ren_dev[:, f0], cap_dev[:, f0], ren_dev[:, f1], cap_dev[:, f1]

    def keep(outs, levels, delays, pair_outs):
        for out, _, stats in pair_outs:
            outs.append(out[idx])
            levels.append(stats[rec][idx])
            delays.append(stats["delay_ms"][idx])

    # Eager: the pair body itself, the volume taking frame 1's
    # recommendation on the device between pairs, as between replays.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = apm.init_state(geo, Bp)
    volume = torch.full((Bp,), AGC1_START_LEVEL, dtype=torch.int32,
                        device=dev)
    e_outs, e_levels, e_delays = [], [], []
    _reset_counts()
    t1 = time.perf_counter()
    for p in range(AGC1_EAGER // 2):
        pair_outs = step_graph.step_pair(geo, state, *frames(p), volume)
        volume.copy_(pair_outs[1][2][rec])
        keep(e_outs, e_levels, e_delays, pair_outs)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t1) * 1000.0 / AGC1_EAGER
    eager_launches = _counts()
    want = expected_aec3_launches(geo, AGC1_EAGER)
    if eager_launches != want:
        raise AssertionError(f"agc1_hybrid_48k launches {eager_launches}, "
                             f"expected {want}")
    del state

    # Graphed from init_state: three pair graphs over one state.
    graph = step_graph.PairGraph(geo, apm.init_state(geo, Bp))
    graph.volume.fill_(AGC1_START_LEVEL)
    reserved = torch.cuda.memory_reserved()
    _reset_counts()
    graph.capture()
    captured = _counts()
    pool_gb = (torch.cuda.memory_reserved() - reserved) / 1e9
    want = expected_aec3_launches(geo, period)
    if captured != want:
        raise AssertionError(f"agc1_hybrid_48k captured {captured} launches "
                             f"a period, expected {want}")
    replays = AGC1_FRAMES // 2
    first_timed = replays - AEC3_TIMED // 2
    timer_start = torch.cuda.Event(enable_timing=True)
    timer_end = torch.cuda.Event(enable_timing=True)
    g_outs, g_levels, g_delays, finite = [], [], [], []
    syncs = None
    for p in range(replays):
        if p == AGC1_CPU_PAIR:
            before = select_streams(graph.state, idx, "cpu")
            before_volume = graph.volume[idx].cpu()
        if p == first_timed:
            torch.cuda.synchronize()
            host_t0 = time.perf_counter()
            timer_start.record()
        if p == first_timed - 1:
            out_pair = []
            syncs = _sync_count(lambda: out_pair.append(
                graph.replay(*frames(p))))
            pair_outs = out_pair[0]
        else:
            pair_outs = graph.replay(*frames(p))
        graph.volume.copy_(pair_outs[1][2][rec])
        keep(g_outs, g_levels, g_delays, pair_outs)
        finite.append(torch.stack([torch.isfinite(o).all()
                                   for o, _, _ in pair_outs]).all())
        if p == AGC1_CPU_PAIR:
            after = select_streams(graph.state, idx, "cpu")
            card_pair = [o[idx].cpu() for o, _, _ in pair_outs]
    timer_end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - host_t0) * 1000.0 / AEC3_TIMED
    dev_ms = timer_start.elapsed_time(timer_end) / AEC3_TIMED
    kernels = bench.device_kernels(
        [lambda: graph.replay(*frames(replays - 1))],
        [lambda: graph.replay(*frames(replays - 1))] * 2) / 2
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not bool(torch.stack(finite).all()):
        raise AssertionError("non-finite output on agc1_hybrid_48k")

    # The graph against the eager run, frame by frame.
    def stacked(xs):
        return torch.stack(xs, dim=1).cpu().numpy()

    ge_out = torch.cat(g_outs[:AGC1_EAGER], dim=1).cpu().numpy()
    ee_out = torch.cat(e_outs, dim=1).cpu().numpy()
    same_out = bool(np.array_equal(ge_out, ee_out))
    same_levels = bool(np.array_equal(stacked(g_levels[:AGC1_EAGER]),
                                      stacked(e_levels)))
    same_delay = bool(np.array_equal(stacked(g_delays[:AGC1_EAGER]),
                                     stacked(e_delays)))
    levels = stacked(g_levels)  # (S, frames)
    # The last pass over the scene.
    got_out = torch.cat(g_outs[-AEC3_FRAMES:], dim=1).cpu().numpy()
    even = [i for i, s in enumerate(AGC1_CHECK) if s % 2 == 0]
    odd = [i for i, s in enumerate(AGC1_CHECK) if s % 2 == 1]
    check = list(AGC1_CHECK)
    erle = erle_db(capture[[check[i] for i in even]],
                   render[[check[i] for i in even]], got_out[even], frame)

    # One pair on the CPU from the card's state before frame 560.
    t2 = time.perf_counter()
    cpu_state = before
    cpu_outs = step_graph.step_pair(
        geo, cpu_state, *(x[idx].cpu() for x in frames(AGC1_CPU_PAIR)),
        before_volume)
    cpu_rel = [float(np.sqrt(((c[0].numpy() - g.numpy()) ** 2).sum(
        axis=(1, 2)) / (g.numpy() ** 2).sum(axis=(1, 2))).max())
        for c, g in zip(cpu_outs, card_pair)]
    card_ints, cpu_ints = _agc1_leaves(after), _agc1_leaves(cpu_state)
    int_diff = sorted(k for k in card_ints
                      if not np.array_equal(card_ints[k], cpu_ints[k]))
    cpu_s = time.perf_counter() - t2

    # Every stream's last recommendation is the graph's volume input.
    final = graph.volume.cpu().numpy()
    raised_share = float((final[1::2] > AGC1_START_LEVEL).mean())
    even_moved_share = float((final[0::2] != AGC1_START_LEVEL).mean())
    launches = {k: v * (replays // (period // 2))
                for k, v in captured.items()}
    main_ms = 10.0 * 4096 / main_streams
    phase("agc1_hybrid_48k", streams=Bp, frames=AGC1_FRAMES,
          voice_amplitude=AGC1_VOICE_AMP,
          eager_frames=AGC1_EAGER, period=period,
          eager_ms_per_frame=eager_ms, eager_launches=eager_launches,
          launches_captured_per_period=captured, launches=launches,
          timed_frames=AEC3_TIMED, ms_per_frame=host_ms,
          event_ms_per_frame=dev_ms,
          realtime_streams=Bp * min(10.0 / host_ms, 1.0),
          device_kernels_per_frame=kernels,
          capture_seconds=graph.capture_seconds, peak_mem_gb=peak_gb,
          graph_pool_gb=pool_gb, host_syncs_per_replay=syncs[0],
          host_sync_sites=syncs[1],
          bit_equal_to_eager=same_out and same_levels and same_delay,
          outputs_equal=same_out, levels_equal=same_levels,
          delay_ms_equal=same_delay,
          final_levels=dict(zip(map(str, AGC1_CHECK),
                                levels[:, -1].tolist())),
          odd_streams_raised_share=raised_share,
          even_streams_moved_share=even_moved_share,
          level_track=dict(zip(map(str, AGC1_CHECK),
                               levels[:, ::60].tolist())),
          erle_db=dict(zip(map(str, [check[i] for i in even]),
                           erle.tolist())),
          cpu_pair_rel_rms=cpu_rel, cpu_int_leaves_differing=int_diff,
          cpu_seconds=round(cpu_s, 3), input_seconds=round(setup_s, 3),
          default_48k_graphed_ms_per_frame=main_ms,
          default_48k_graphed_realtime_streams=main_streams, card=smi)
    if not (same_out and same_levels and same_delay):
        raise AssertionError(
            f"agc1_hybrid_48k graphed differs from eager: outputs "
            f"{same_out}, levels {same_levels}, delays {same_delay}")
    if syncs[0]:
        raise AssertionError(f"{syncs[0]} host syncs in a replay: "
                             f"{syncs[1]}")
    if not (levels[odd, -1] > AGC1_START_LEVEL).all():
        raise AssertionError(f"the AGC did not raise the speech streams' "
                             f"level: {levels[odd, -1]}")
    if not (erle > ERLE_BAR_DB).all():
        raise AssertionError(f"ERLE {erle} dB not above {ERLE_BAR_DB} dB")
    if max(cpu_rel) > AGC1_CPU_RTOL or int_diff:
        raise AssertionError(f"the CPU pair differs from the card's: rel RMS "
                             f"{cpu_rel}, integer leaves {int_diff}")
    return eager_launches, launches


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
    walls, launches, eager_out, streams = {}, {}, {}, {}
    for path in AEC3_PATHS:
        t0 = time.perf_counter()
        run, launches[path.name] = aec3_path_phase(dev, smi, path)
        eager_out[path.name] = run[4]
        t1 = time.perf_counter()
        aec3_cross_check_phase(path, *run)
        t2 = time.perf_counter()
        graphed = f"{path.name}_graphed"
        launches[graphed], streams[graphed] = graphed_path_phase(
            dev, smi, path, *run[4:])
        walls[path.name] = round(t1 - t0, 3)
        walls[f"{path.name}_cross_check"] = round(t2 - t1, 3)
        walls[graphed] = round(time.perf_counter() - t2, 3)
    t2 = time.perf_counter()
    slice_path_phase(dev, smi)
    t3 = time.perf_counter()
    bench_twin_phase(dev, smi)
    t4 = time.perf_counter()
    launches["api_48k_stereo"] = api_phase(dev, smi)
    t5 = time.perf_counter()
    launches["engine_default_48k"] = engine_phase(
        dev, smi, eager_out["default_48k"], streams["default_48k_graphed"])
    t6 = time.perf_counter()
    (launches["agc1_hybrid_48k"],
     launches["agc1_hybrid_48k_graphed"]) = agc1_hybrid_phase(
        dev, smi, streams["default_48k_graphed"])
    t7 = time.perf_counter()
    (launches["aecm_fixed_16k"], launches["aecm_fixed_16k_graphed"],
     limiter_inputs) = aecm_fixed_phase(dev, smi,
                                        streams["default_48k_graphed"])
    limiter = next(r for r in rows if r["name"] == "agc1_limiter")
    limiter.setdefault("other_shapes", {})["aecm_fixed_16k_path_gains"] = (
        limiter_times(dev, *limiter_inputs))
    phase("kernel_on_path_data", name="agc1_limiter", path="aecm_fixed_16k",
          **limiter["other_shapes"]["aecm_fixed_16k_path_gains"])
    t8 = time.perf_counter()
    (launches["aecm_fixed_8k"],
     launches["aecm_fixed_8k_graphed"]) = aecm_8k_phase(dev, smi)
    t9 = time.perf_counter()
    phase("wall_seconds", **walls, slice_path=round(t3 - t2, 3),
          bench_twin=round(t4 - t3, 3), api_48k_stereo=round(t5 - t4, 3),
          engine_default_48k=round(t6 - t5, 3),
          agc1_hybrid_48k=round(t7 - t6, 3), aecm_fixed_16k=round(t8 - t7, 3),
          aecm_fixed_8k=round(t9 - t8, 3), total=round(t9 - t_all, 3))
    # Each kernel's launches on the path it serves: K6 on the 48 kHz stereo
    # pair-kernel path, AGC1's limiter on the hybrid AGC's path, K1-K5 on
    # the main path (the default pipeline); every path beside them, the
    # graphed ones as launches captured per pair (or period) x replays.
    main_paths = {"subtractor_pair": "pair_kernel_48k",
                  "agc1_limiter": "agc1_hybrid_48k"}
    for r in rows:
        main_path = main_paths.get(r["name"], "default_48k")
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
