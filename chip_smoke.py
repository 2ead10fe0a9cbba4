"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its result; any failed check raises and the script
exits non-zero without a result line:

1. device: the card's name and power limit; TF32 off.
2. build: the CUDA kernels built from ``webrtc_audio_processing_tpu_torch/
   csrc`` with nvcc (sm_90a) and loaded with ctypes.
3. kernels: K1 (biquad cascade) and K5 (window read) against their plain
   PyTorch twins on the card at the slice's shapes, bit for bit, with
   CUDA-event times of both.
4. main path: B = 2048 streams of 48 kHz stereo through
   ``apm.process_stream_pair`` (HPF + NS + AGC2 with the RNN-VAD), 10
   warm-up and 100 timed frames after one onset frame; each kernel must
   launch exactly once per frame.
5. cross-check: 4 of the streams rerun on the CPU by the same port (plain
   twins) from the same state and inputs for the same 110 frames.

The second-to-last line is the kernel table as JSON, the last line the
result JSON. The script imports no JAX.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

B = 2048
WARMUP = 10
TIMED = 100
CHECK_STREAMS = (0, 683, 1366, 2047)
SEED = 20261016
RTOL_RMS = 1e-3  # BASELINE.md deviation bar, per stream
PROB_ATOL = 1e-3


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


def kernels_phase(dev):
    from webrtc_audio_processing_tpu_torch.ops import (
        biquad,
        cuda_biquad,
        cuda_window,
    )

    rng = np.random.default_rng(SEED)
    rows = []

    # K1 at the HPF's shapes: M = B streams x 2 channels, T = 480, K = 3.
    coeffs = torch.from_numpy(
        biquad.pack_coeffs(*biquad.HPF_COEFFS[48000])).to(dev)
    M = 2 * B
    x_t = torch.from_numpy(
        (rng.standard_normal((480, M)) * 3000).astype(np.float32)).to(dev)
    st = torch.from_numpy(
        (rng.standard_normal((12, M)) * 1000).astype(np.float32)).to(dev)
    st_k, y_k = cuda_biquad.cascade_cuda(coeffs, st, x_t)
    st_p, y_p = cuda_biquad.cascade_plain(coeffs, st, x_t)
    torch.cuda.synchronize()
    err = max(float((y_k - y_p).abs().max()), float((st_k - st_p).abs().max()))
    if not (torch.equal(y_k, y_p) and torch.equal(st_k, st_p)):
        raise AssertionError(f"K1 differs from its twin: max |diff| {err}")
    rows.append(dict(
        name="biquad_cascade", route="cuda",
        source="webrtc_audio_processing_tpu_torch/csrc/biquad.cu",
        replaces="webrtc_audio_processing_tpu/ops/pallas_biquad.py:32",
        max_abs_err=err,
        ms=_event_ms(lambda: cuda_biquad.cascade_cuda(coeffs, st, x_t), 50),
        plain_ms=_event_ms(lambda: cuda_biquad.cascade_plain(coeffs, st, x_t),
                           3),
    ))

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
    rows.append(dict(
        name="take_windows", route="cuda",
        source="webrtc_audio_processing_tpu_torch/csrc/window.cu",
        replaces="webrtc_audio_processing_tpu/ops/pallas_window.py:21",
        max_abs_err=err,
        ms=_event_ms(lambda: cuda_window.take_windows_cuda(buf, start, 480),
                     200),
        plain_ms=_event_ms(
            lambda: cuda_window.take_windows_plain(buf, start, 480), 200),
    ))
    for r in rows:
        phase("kernel", **r)
    return rows


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


def select_streams(state, idx, device):
    """The state of streams ``idx`` (batch axis first) on ``device``."""
    if state is None:
        return None
    if dataclasses.is_dataclass(state):
        return type(state)(**{
            f.name: select_streams(getattr(state, f.name), idx, device)
            for f in dataclasses.fields(state)
        })
    return state[idx].to(device)


def main_path_phase(dev, smi):
    from webrtc_audio_processing_tpu_torch import apm, config as cfg_mod
    from webrtc_audio_processing_tpu_torch.ops import cuda_biquad, cuda_window

    geo = apm.ApmGeometry.create(slice_config(cfg_mod), 48000, 2,
                                 num_render_channels=2)
    n = 1 + WARMUP + TIMED
    t0 = time.perf_counter()
    captures = speech_like(n, SEED)
    renders = speech_like(n, SEED + 1)
    setup_s = time.perf_counter() - t0
    cap_dev = torch.from_numpy(captures).to(dev)
    ren_dev = torch.from_numpy(renders).to(dev)

    # Onset frame (set-up): a stream's first frame searches pitch in a
    # mostly empty buffer, where near-ties make the period depend on float
    # noise; the compared run starts from the state after it.
    state = apm.init_state(geo, B, dev)
    state, _, _, _ = apm.process_stream_pair(geo, state, cap_dev[0],
                                             ren_dev[0])
    idx = torch.tensor(CHECK_STREAMS, device=dev)
    cpu_state = select_streams(state, idx, "cpu")
    torch.cuda.synchronize()

    cuda_biquad.launches = 0
    cuda_window.launches = 0
    outs, probs, finite = [], [], []
    timer_start = torch.cuda.Event(enable_timing=True)
    timer_end = torch.cuda.Event(enable_timing=True)
    for f in range(1, n):
        if f == 1 + WARMUP:
            torch.cuda.synchronize()
            host_t0 = time.perf_counter()
            timer_start.record()
        state, out, rout, stats = apm.process_stream_pair(
            geo, state, cap_dev[f], ren_dev[f])
        outs.append(out[idx])
        probs.append(stats["agc2_speech_probability"][idx])
        finite.append(torch.isfinite(out).all() & torch.isfinite(rout).all())
    timer_end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - host_t0) * 1000.0 / TIMED
    dev_ms = timer_start.elapsed_time(timer_end) / TIMED
    launches = {"biquad_cascade": cuda_biquad.launches,
                "take_windows": cuda_window.launches}
    if launches != {"biquad_cascade": n - 1, "take_windows": n - 1}:
        raise AssertionError(
            f"expected one launch per frame ({n - 1}), got {launches}")
    if not bool(torch.stack(finite).all()):
        raise AssertionError("non-finite output on the main path")
    if tuple(out.shape) != (B, 480, 2):
        raise AssertionError(f"output shape {tuple(out.shape)}")
    streams = B * min(10.0 / host_ms, 1.0)
    phase("main_path", streams=B, frames=n - 1, timed_frames=TIMED,
          ms_per_frame=host_ms, event_ms_per_frame=dev_ms,
          realtime_streams=streams, launches=launches,
          input_seconds=round(setup_s, 3), card=smi,
          peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    gpu_out = torch.stack(outs, dim=1).cpu().numpy()  # (4, 110, 480, 2)
    gpu_prob = torch.stack(probs, dim=1).cpu().numpy()  # (4, 110)
    return geo, cpu_state, captures, renders, gpu_out, gpu_prob, launches


def cross_check_phase(geo, cpu_state, captures, renders, gpu_out, gpu_prob):
    from webrtc_audio_processing_tpu_torch import apm

    idx = list(CHECK_STREAMS)
    state = cpu_state
    outs, probs = [], []
    t0 = time.perf_counter()
    for f in range(1, captures.shape[0]):
        state, out, _, stats = apm.process_stream_pair(
            geo, state, torch.from_numpy(captures[f, idx]),
            torch.from_numpy(renders[f, idx]))
        outs.append(out.numpy())
        probs.append(stats["agc2_speech_probability"].numpy())
    cpu_out = np.stack(outs, axis=1)
    cpu_prob = np.stack(probs, axis=1)
    rel = np.sqrt(((gpu_out - cpu_out) ** 2).sum(axis=(1, 2, 3))
                  / (cpu_out ** 2).sum(axis=(1, 2, 3)))
    dprob = np.abs(gpu_prob - cpu_prob).max(axis=1)
    phase("cross_check", streams=idx, frames=int(cpu_out.shape[1]),
          rel_rms=rel.tolist(), max_abs_dprob=dprob.tolist(),
          cpu_seconds=round(time.perf_counter() - t0, 3))
    if not (rel <= RTOL_RMS).all():
        raise AssertionError(f"relative RMS {rel} exceeds {RTOL_RMS}")
    if not (dprob <= PROB_ATOL).all():
        raise AssertionError(f"speech probability differs by {dprob}")


def main():
    smi = device_phase()
    dev = torch.device("cuda", 0)
    build_phase()
    rows = kernels_phase(dev)
    geo, cpu_state, caps, rens, gpu_out, gpu_prob, launches = \
        main_path_phase(dev, smi)
    cross_check_phase(geo, cpu_state, caps, rens, gpu_out, gpu_prob)
    for r in rows:
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": [
        {k: r[k] for k in ("name", "route", "source", "replaces", "launches",
                           "max_abs_err", "ms", "plain_ms")} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
