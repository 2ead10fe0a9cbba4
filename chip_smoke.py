"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its result; any failed check raises and the script
exits non-zero without a result line:

1. device: the card's name and power limit; TF32 off.
2. build: the CUDA kernels built from ``webrtc_audio_processing_tpu_torch/
   csrc`` with nvcc (sm_90a, one nvcc per source, all at once) and loaded
   with ctypes.
3. kernels: K1 (biquad cascade, at the HPF's, the AEC3 decimators' and the
   PostFilter's shapes), K2 (ring span read), K3 (matched-filter NLMS
   bank), K4 (pre-echo errors) and K5 (window read) against their plain
   PyTorch twins on the card at the main path's shapes, with CUDA-event
   times of kernel, twin and, for K2 and K5, the one PyTorch call that
   computes the same function (``torch.gather`` on a prebuilt index).
4. AEC3 main path: B = 2048 streams of 48 kHz stereo through
   ``apm.process_stream_pair`` with HPF, multichannel AEC3, NS and AGC2
   (the bench's configuration, bench.py:53-78), 300 frames (3 s) of an
   echo scene; the last 100 frames timed. Every kernel must launch the
   number of times the code implies, and the echo must be cancelled (ERLE
   over the last third above 6 dB, tests/test_apm_48k_stereo.py's bar).
5. AEC3 cross-check: streams 0 and 2047 of frames 100-199 rerun on the
   CPU by the same port (plain twins) from the card's state before each
   frame: relative RMS <= 1e-3 and the same delay on every frame. The
   free-running rerun from frame 100 is printed beside it: AEC3 turns
   float noise into decisions (the refined filter's leakage choice when
   the refined and coarse error energies tie to a few ulps), so two
   devices drift apart within tens of frames with the same ERLE
   (tools/torch_card_vs_cpu.py finds the first diverging leaf).
6. slice-1 path (echo canceller off): 30 timed frames, one K1 and one K5
   launch per frame, and its cross-check on 4 streams.

Before the last line the kernel table as JSON, then the result JSON. The
script imports no JAX.
"""

from __future__ import annotations

import dataclasses
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
AEC3_CHECK = (0, 2047)
CROSS_FROM = 100
CROSS_FRAMES = 100

SLICE_WARMUP = 10
SLICE_TIMED = 30
SLICE_CHECK = (0, 683, 1366, 2047)

# The card's peaks for the bounds: HBM bandwidth and float32 rate outside
# the tensor cores (NVIDIA's H100 SXM data sheet). K1's chain is bounded by
# its dependent-instruction latency: 4 cycles per dependent operation at
# the 1,980 MHz boost clock.
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
    regs = [ln.strip() for ln in lib.log.splitlines() if "registers" in ln]
    phase("build", seconds=round(time.perf_counter() - t0, 3),
          nvcc_seconds=round(lib.build_seconds, 3), library=lib.path.name,
          ptxas=regs)


def _event_ms(fn, n):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


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
    bound, by = _bound_ms((2 * T * M + 8 * K * M) * 4,
                          chain_s=T * K * 4 * DEP_OP_S)
    return dict(
        max_abs_err=err,
        ms=_event_ms(lambda: cuda_biquad.cascade_cuda(coeffs, st, x_t), 50),
        plain_ms=_event_ms(lambda: cuda_biquad.cascade_plain(coeffs, st,
                                                             x_t), 2),
        bound_ms=bound, bound_by=by, shape=f"K={K} T={T} M={M}",
    )


def kernels_phase(dev):
    from webrtc_audio_processing_tpu_torch.models import post_filter
    from webrtc_audio_processing_tpu_torch.models.aec3 import render_buffer
    from webrtc_audio_processing_tpu_torch.ops import (
        biquad,
        cuda_matched_filter,
        cuda_pre_echo,
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
        library_ms=None,
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
            ms=_event_ms(lambda: cuda_span.span_gather_cuda(ring, start, W),
                         200),
            plain_ms=_event_ms(
                lambda: cuda_span.span_gather_plain(ring, start, W), 50),
            library_ms=_event_ms(lambda: torch.gather(ring, 1, idx), 200),
            bound_ms=bound, bound_by=by, shape=f"B={B} LP=200 W={W} F={F}")

    k2 = k2_case(19, 512)
    rows.append(dict(
        name="span_gather", route="cuda",
        source="webrtc_audio_processing_tpu_torch/csrc/span.cu",
        replaces="webrtc_audio_processing_tpu/ops/pallas_span.py:47",
        library_note="torch.gather with a prebuilt index",
        other_shapes={"blocks": k2_case(15, 384)}, **k2))

    # K3 at the matched filter's shapes: 5 filters of 512 taps, DS = 2448.
    f32 = np.float32
    low = torch.from_numpy(
        rng.standard_normal((B, 2448)).astype(f32) * 400).to(dev)
    lr = torch.from_numpy(rng.integers(0, 2448, B).astype(np.int32)).to(dev)
    h0 = torch.from_numpy(
        rng.standard_normal((B, 5, 512)).astype(f32) * 0.01).to(dev)
    y = torch.from_numpy(rng.standard_normal((B, 16)).astype(f32) * 400).to(
        dev)
    sm = torch.full((B,), 0.7, device=dev)
    kw = dict(shift=384, ds_size=2448, threshold=512 * 150.0 ** 2)
    got = cuda_matched_filter.nlms_cuda(low, lr, h0, y, sm, **kw)
    want = cuda_matched_filter.nlms_plain(low, lr, h0, y, sm, **kw)
    torch.cuda.synchronize()
    rel = max(_max_rel(g, w) for g, w in zip(got[:3], want[:3]))
    if rel > 2e-5 or not (torch.equal(got[3], want[3])
                          and torch.equal(got[4], want[4])):
        raise AssertionError(f"K3 differs from its twin: max-relative {rel}")
    n_bytes = (B * 2448 + 2 * B * 5 * 512 + B * 5 * 527 + B * 5 * 18
               + B * 17) * 4
    bound, by = _bound_ms(n_bytes, n_ops=B * 5 * 16 * 512 * 6)
    rows.append(dict(
        name="matched_filter_nlms", route="cuda",
        source="webrtc_audio_processing_tpu_torch/csrc/matched_filter.cu",
        replaces="webrtc_audio_processing_tpu/ops/pallas_mf.py:31",
        max_abs_err=max(float((g - w).abs().max())
                        for g, w in zip(got[:3], want[:3])),
        max_rel_err=rel,
        ms=_event_ms(lambda: cuda_matched_filter.nlms_cuda(
            low, lr, h0, y, sm, **kw), 50),
        plain_ms=_event_ms(lambda: cuda_matched_filter.nlms_plain(
            low, lr, h0, y, sm, **kw), 5),
        library_ms=None,
        library_note="none: no PyTorch call runs a per-sample NLMS",
        bound_ms=bound, bound_by=by, shape=f"B={B} N=5 taps=512 sub=16"))

    # K4 at the winner filter's shapes.
    seg = got[4][:, 0].contiguous()
    h0w = h0[:, 0].contiguous()
    al = (got[1][:, 0] * 1.0).contiguous()
    pe_k = cuda_pre_echo.pre_echo_cuda(seg, h0w, al, y, 4)
    pe_p = cuda_pre_echo.pre_echo_plain(seg, h0w, al, y, 4)
    torch.cuda.synchronize()
    norm = float(((pe_k - pe_p) / torch.clamp(pe_p.abs(), min=1.0)).abs()
                 .max())
    if norm > 2e-4:
        raise AssertionError(f"K4 differs from its twin: {norm}")
    bound, by = _bound_ms(B * (527 + 512 + 32 + 128) * 4,
                          n_ops=B * 16 * 512 * 5)
    rows.append(dict(
        name="pre_echo_inst", route="cuda",
        source="webrtc_audio_processing_tpu_torch/csrc/pre_echo.cu",
        replaces="webrtc_audio_processing_tpu/ops/pallas_pre_echo.py:59",
        max_abs_err=float((pe_k - pe_p).abs().max()), max_norm_err=norm,
        ms=_event_ms(lambda: cuda_pre_echo.pre_echo_cuda(seg, h0w, al, y, 4),
                     200),
        plain_ms=_event_ms(lambda: cuda_pre_echo.pre_echo_plain(
            seg, h0w, al, y, 4), 10),
        library_ms=None,
        library_note="none: no PyTorch call computes the chunked errors",
        bound_ms=bound, bound_by=by, shape=f"B={B} taps=512 sub=16"))

    # K5 at the RNN-VAD's shapes: B = 2048, L = 864, W = 480.
    buf = torch.from_numpy(
        rng.standard_normal((B, 864)).astype(np.float32)).to(dev)
    start = torch.from_numpy(
        rng.integers(0, 385, B).astype(np.int32)).to(dev)
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
        ms=_event_ms(lambda: cuda_window.take_windows_cuda(buf, start, 480),
                     200),
        plain_ms=_event_ms(
            lambda: cuda_window.take_windows_plain(buf, start, 480), 200),
        library_ms=_event_ms(lambda: torch.gather(buf, 1, idx), 200),
        library_note="torch.gather with a prebuilt index",
        bound_ms=bound, bound_by=by, shape=f"B={B} L=864 W=480"))
    for r in rows:
        phase("kernel", **r)
    return rows


# --------------------------------------------------------------- inputs


def echo_scene(n_frames, seed, streams):
    """The render scene of tests/test_apm_48k_stereo.py per stream (a noise
    burst train with a slow level swing, the same far end on both
    channels; the phases from the stream's own generator), and the
    capture: its echo through two short paths plus -40 dBFS noise.
    Returns (render, capture), each (len(streams), n, 2) float32 in
    [-1, 1], n = 480 * n_frames."""
    n = n_frames * 480
    t = (np.arange(n) / 48000.0).astype(np.float32)
    render = np.empty((len(streams), n, 2), np.float32)
    capture = np.empty((len(streams), n, 2), np.float32)
    for i, s in enumerate(streams):
        rng = np.random.default_rng([seed, s])
        p1, p2 = rng.uniform(0, 2 * np.pi, 2)
        burst = (np.sin(2 * np.pi * 2.3 * t + p1) > -0.2).astype(np.float32)
        level = 0.15 + 0.85 * np.abs(np.sin(2 * np.pi * 0.4 * t + p2))
        far = rng.standard_normal(n, dtype=np.float32) * (0.2 * burst * level)
        render[i, :, 0] = far
        render[i, :, 1] = far
        capture[i, :, 0] = 0.4 * far + 0.15 * np.roll(far, 5)
        capture[i, :, 1] = 0.35 * far + 0.12 * np.roll(far, 9)
        capture[i] += 0.01 * rng.standard_normal((n, 2), dtype=np.float32)
    return render, capture


def erle_db(capture, render, out):
    """ERLE over the last third as tests/test_apm_48k_stereo.py measures
    it: capture and output power where the far end is active. Arrays
    (S, n, 2); returns (S,) dB."""
    n = capture.shape[1]
    tail = slice(2 * n // 3, n - 480)
    act = np.abs(render[:, tail, 0]) > 1e-4
    e_in = (capture[:, tail] ** 2 * act[..., None]).sum(axis=(1, 2)) / (
        2 * act.sum(axis=1)) + 1e-12
    e_out = (out[:, tail] ** 2 * act[..., None]).sum(axis=(1, 2)) / (
        2 * act.sum(axis=1)) + 1e-12
    return 10 * np.log10(e_in / e_out)


def select_streams(state, idx, device):
    """The state of streams ``idx`` (batch axis first) on ``device``; plain
    ints (the frame counter) carry over. CUDA indexes no uint32 tensor
    (the comfort-noise seed), so those go through int64."""
    if state is None or isinstance(state, int):
        return state
    if dataclasses.is_dataclass(state):
        return type(state)(**{
            f.name: select_streams(getattr(state, f.name), idx, device)
            for f in dataclasses.fields(state)
        })
    if state.dtype == torch.uint32:
        return state.to(torch.int64)[idx].to(device).to(torch.uint32)
    return state[idx].to(device)


def _kernel_modules():
    from webrtc_audio_processing_tpu_torch.ops import (
        cuda_biquad,
        cuda_matched_filter,
        cuda_pre_echo,
        cuda_span,
        cuda_window,
    )

    return {"biquad_cascade": cuda_biquad, "span_gather": cuda_span,
            "matched_filter_nlms": cuda_matched_filter,
            "pre_echo_inst": cuda_pre_echo, "take_windows": cuda_window}


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


# ------------------------------------------------------------- AEC3 path


def aec3_config(cfg_mod):
    return cfg_mod.Config().replace(
        pipeline=cfg_mod.Pipeline(multi_channel_capture=True,
                                  multi_channel_render=True,
                                  maximum_internal_processing_rate=48000),
        high_pass_filter=cfg_mod.HighPassFilter(enabled=True),
        echo_canceller=cfg_mod.EchoCanceller(enabled=True),
        noise_suppression=cfg_mod.NoiseSuppression(enabled=True),
        gain_controller2=cfg_mod.GainController2(
            enabled=True,
            adaptive_digital=cfg_mod.AdaptiveDigital(enabled=True)),
    )


def expected_aec3_launches(n_frames):
    """Per frame pair: K1 2 HPF + 2 PostFilter + 5 render and 5 capture
    decimations (one launch for both cascades); K2 the echo remover's four
    chain reads per frame; K3 and K4 one per capture block; K5 one per
    frame."""
    pairs, odd = divmod(n_frames, 2)
    blocks = 5 * pairs + 2 * odd
    return {"biquad_cascade": 2 * n_frames + 2 * blocks,
            "span_gather": 4 * n_frames,
            "matched_filter_nlms": blocks, "pre_echo_inst": blocks,
            "take_windows": n_frames}


def aec3_path_phase(dev, smi):
    from webrtc_audio_processing_tpu_torch import apm, config as cfg_mod

    t0 = time.perf_counter()
    render, capture = echo_scene(AEC3_FRAMES, SEED, range(B))
    ren_dev = torch.from_numpy(render).to(dev)
    cap_dev = torch.from_numpy(capture).to(dev)
    setup_s = time.perf_counter() - t0

    geo = apm.ApmGeometry.create(aec3_config(cfg_mod), 48000, 2,
                                 num_render_channels=2,
                                 aec3_stereo_content=True)
    state = apm.init_state(geo, B)
    idx = torch.tensor(AEC3_CHECK, device=dev)
    torch.cuda.reset_peak_memory_stats()
    outs, delays, finite = [], [], []
    snapshots = []
    syncs, sync_sites = None, None
    timer_start = torch.cuda.Event(enable_timing=True)
    timer_end = torch.cuda.Event(enable_timing=True)
    first_timed = AEC3_FRAMES - AEC3_TIMED

    def step(f):
        nonlocal state
        sl = slice(f * 480, (f + 1) * 480)
        state, out, rout, stats = apm.process_stream_pair(
            geo, state, cap_dev[:, sl], ren_dev[:, sl])
        outs.append(out[idx])
        delays.append(stats["delay_ms"][idx])
        finite.append(torch.isfinite(out).all() & torch.isfinite(rout).all())
        return out

    t_run = time.perf_counter()
    _reset_counts()
    for f in range(AEC3_FRAMES):
        if CROSS_FROM <= f < CROSS_FROM + CROSS_FRAMES:
            snapshots.append(select_streams(state, idx, "cpu"))
        if f == first_timed - 1:
            syncs, sync_sites = _sync_count(lambda f=f: step(f))
            continue
        if f == first_timed:
            torch.cuda.synchronize()
            host_t0 = time.perf_counter()
            timer_start.record()
        out = step(f)
    timer_end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - host_t0) * 1000.0 / AEC3_TIMED
    dev_ms = timer_start.elapsed_time(timer_end) / AEC3_TIMED
    run_s = time.perf_counter() - t_run
    launches = _counts()
    want = expected_aec3_launches(AEC3_FRAMES)
    if launches != want:
        raise AssertionError(f"AEC3 path launches {launches}, expected "
                             f"{want}")
    if not bool(torch.stack(finite).all()):
        raise AssertionError("non-finite output on the AEC3 path")
    if tuple(out.shape) != (B, 480, 2):
        raise AssertionError(f"output shape {tuple(out.shape)}")
    gpu_out = torch.cat(outs, dim=1).cpu().numpy()  # (2, n, 2)
    erle = erle_db(capture[list(AEC3_CHECK)], render[list(AEC3_CHECK)],
                   gpu_out)
    phase("aec3_path", streams=B, frames=AEC3_FRAMES, timed_frames=AEC3_TIMED,
          ms_per_frame=host_ms, event_ms_per_frame=dev_ms,
          realtime_streams=B * min(10.0 / host_ms, 1.0),
          launches=launches, expected_launches=want,
          host_syncs_per_frame=syncs, host_sync_sites=sync_sites,
          sync_counter_check=_sync_count(
              lambda: torch.ones(1, device=dev).item())[0],
          card=smi,
          peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
          erle_db=dict(zip(map(str, AEC3_CHECK), erle.tolist())),
          input_seconds=round(setup_s, 3), run_seconds=round(run_s, 3))
    if not (erle > ERLE_BAR_DB).all():
        raise AssertionError(f"ERLE {erle} dB not above {ERLE_BAR_DB} dB")
    gpu_delay = torch.stack(delays, dim=1).cpu().numpy()
    return (geo, snapshots, render[list(AEC3_CHECK)],
            capture[list(AEC3_CHECK)], gpu_out, gpu_delay, launches)


def _rel_rms(got, want):
    return np.sqrt(((got - want) ** 2).sum(axis=(1, 2))
                   / (want ** 2).sum(axis=(1, 2)))


def aec3_cross_check_phase(geo, snapshots, render, capture, gpu_out,
                           gpu_delay):
    from webrtc_audio_processing_tpu_torch import apm

    frames = range(CROSS_FROM, CROSS_FROM + CROSS_FRAMES)
    t0 = time.perf_counter()

    def cpu_step(state, f):
        sl = slice(f * 480, (f + 1) * 480)
        state, out, _, stats = apm.process_stream_pair(
            geo, state, torch.from_numpy(capture[:, sl].copy()),
            torch.from_numpy(render[:, sl].copy()))
        return state, out.numpy(), stats["delay_ms"].numpy()

    # The check: one step from the card's state before each frame.
    seeded = [cpu_step(snap, f)[1:] for snap, f in zip(snapshots, frames)]
    # Beside it, free running from the card's state before the first.
    state, free = snapshots[0], []
    for f in frames:
        state, out, delay = cpu_step(state, f)
        free.append((out, delay))
    g = gpu_out[:, CROSS_FROM * 480:(CROSS_FROM + CROSS_FRAMES) * 480]
    g_delay = gpu_delay[:, CROSS_FROM:CROSS_FROM + CROSS_FRAMES]

    def compare(runs):
        out = np.concatenate([o for o, _ in runs], axis=1)
        delay = np.stack([d for _, d in runs], axis=1)
        per_frame = [_rel_rms(g[:, k * 480:(k + 1) * 480],
                              out[:, k * 480:(k + 1) * 480]).max()
                     for k in range(CROSS_FRAMES)]
        first = next((k for k, e in enumerate(per_frame) if e > RTOL_RMS),
                     None)
        return (_rel_rms(g, out), bool((delay == g_delay).all()),
                None if first is None else CROSS_FROM + first)

    rel, same_delay, _ = compare(seeded)
    free_rel, free_delay, free_first = compare(free)
    phase("aec3_cross_check", streams=list(AEC3_CHECK), frames=CROSS_FRAMES,
          first_frame=CROSS_FROM, rel_rms=rel.tolist(),
          delay_ms_equal=same_delay,
          free_running_rel_rms=free_rel.tolist(),
          free_running_delay_ms_equal=free_delay,
          free_running_first_frame_over_bar=free_first,
          cpu_seconds=round(time.perf_counter() - t0, 3))
    if not (rel <= RTOL_RMS).all():
        raise AssertionError(f"relative RMS {rel} exceeds {RTOL_RMS}")
    if not same_delay:
        raise AssertionError("delay_ms differs between card and CPU")


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


def main():
    t_all = time.perf_counter()
    smi = device_phase()
    dev = torch.device("cuda", 0)
    build_phase()
    rows = kernels_phase(dev)
    t0 = time.perf_counter()
    geo, snapshots, ren, cap, gpu_out, gpu_delay, launches = \
        aec3_path_phase(dev, smi)
    t1 = time.perf_counter()
    aec3_cross_check_phase(geo, snapshots, ren, cap, gpu_out, gpu_delay)
    t2 = time.perf_counter()
    slice_path_phase(dev, smi)
    t3 = time.perf_counter()
    phase("wall_seconds", aec3_path=round(t1 - t0, 3),
          aec3_cross_check=round(t2 - t1, 3), slice_path=round(t3 - t2, 3),
          total=round(t3 - t_all, 3))
    for r in rows:
        r["launches"] = launches[r["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_note")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
