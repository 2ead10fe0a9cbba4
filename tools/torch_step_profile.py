"""Where the time of one step goes: the PyTorch port on the card.

    python3 tools/torch_step_profile.py [--batch 2048] [--frames 10]
        [--mode 48k_stereo|16k_mono] [--pair-kernel] [--no-aec3]

Drives ``apm.process_stream_pair`` at one of the bench's configurations
(HPF, AEC3, NS, AGC2; ``--no-aec3`` drops the echo canceller,
``--pair-kernel`` runs AEC3's subtractor on K6) on the echo scene of
``chip_smoke.py`` and prints JSON lines:

- ``stages``: host milliseconds per frame of each stage, each stage call
  wrapped in ``torch.cuda.synchronize()`` (nested stages are included in
  their parents), means over ``--frames`` frames after 10 warm-up frames;
- ``step``: the synchronised whole step, ms per frame;
- ``profile``: from ``torch.profiler`` over 4 frames, the kernel launches
  per frame, the device time per frame and the device's busy share of the
  wall time (the profiler slows the host), and the ten largest device
  items.

Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import argparse
import collections
import functools
import json
import os
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from webrtc_audio_processing_tpu_torch import apm, config as cfg_mod  # noqa
from webrtc_audio_processing_tpu_torch.models import (  # noqa: E402
    audio_buffer,
    echo_detector,
    high_pass_filter,
    noise_suppressor,
    post_filter,
    rms_level,
)
from webrtc_audio_processing_tpu_torch.models.aec3 import (  # noqa: E402
    aec_state,
    delay_estimator,
    echo_canceller3,
    echo_remover,
    render_buffer,
    subtractor,
    subtractor_kernel,
)
from webrtc_audio_processing_tpu_torch.models.agc2 import (  # noqa: E402
    gain_controller2,
)
from webrtc_audio_processing_tpu_torch.models.agc2.rnn_vad import (  # noqa
    pitch,
)

TIMES = collections.defaultdict(float)
ACTIVE = [False]

# (owner, attribute, stage name): functions looked up through their module
# or class at call time, so wrapping the attribute times every call.
STAGES = [
    (apm.Apm, "process_render_stream", "render side"),
    (audio_buffer.AudioBuffer, "split_into_frequency_bands", "band split"),
    (audio_buffer.AudioBuffer, "merge_frequency_bands", "band merge"),
    (high_pass_filter.HighPassFilter, "forward", "HPF"),
    (rms_level, "analyze", "RMS"),
    (noise_suppressor.NoiseSuppressor, "analyze", "NS analyze"),
    (noise_suppressor.NoiseSuppressor, "process", "NS process"),
    (echo_canceller3, "process_frame", "AEC3"),
    (render_buffer, "insert", "AEC3 · render insert"),
    (render_buffer, "flush_sf_pending", "AEC3 · render flush"),
    (echo_canceller3, "_delay_phase_block", "AEC3 · delay phase"),
    (delay_estimator, "get_delay", "AEC3 · · delay estimator"),
    (delay_estimator, "matched_filter_update",
     "AEC3 · · · matched filter (K3, K4)"),
    (echo_remover, "process_capture_pair", "AEC3 · echo remover"),
    (subtractor, "analyzer_update", "AEC3 · · render analyzer"),
    (subtractor, "process_pair", "AEC3 · · subtractor"),
    (subtractor_kernel, "process_pair_kernel", "AEC3 · · subtractor (K6)"),
    (aec_state, "update", "AEC3 · · AEC state"),
    (echo_remover, "comfort_noise_compute", "AEC3 · · comfort noise"),
    (echo_remover, "residual_echo_estimate", "AEC3 · · residual echo"),
    (echo_remover, "suppression_gain_compute", "AEC3 · · suppression gain"),
    (echo_remover, "suppression_filter_apply",
     "AEC3 · · suppression filter"),
    (echo_detector, "analyze_capture_audio", "echo detector"),
    (gain_controller2.GainController2, "forward", "AGC2"),
    (pitch, "estimate_pitch", "AGC2 · pitch search"),
    (post_filter.PostFilter, "forward", "PostFilter"),
]


def _timed(fn, name):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not ACTIVE[0]:
            return fn(*args, **kwargs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        TIMES[name] += time.perf_counter() - t0
        return out
    return wrapper


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--mode", default="48k_stereo",
                    choices=sorted(chip_smoke.BENCH_MODES))
    ap.add_argument("--pair-kernel", action="store_true")
    ap.add_argument("--no-aec3", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for owner, attr, name in STAGES:
        setattr(owner, attr, _timed(getattr(owner, attr), name))

    dev = torch.device("cuda")
    B, warm, n = args.batch, 10, args.frames
    total = warm + n + 4
    rate, channels, _ = chip_smoke.BENCH_MODES[args.mode]
    frame = rate // 100
    render, capture = chip_smoke.echo_scene(total, chip_smoke.SEED, range(B),
                                            rate, channels)
    ren, cap = torch.from_numpy(render).to(dev), torch.from_numpy(
        capture).to(dev)
    if args.no_aec3:
        geo = apm.ApmGeometry.create(chip_smoke.slice_config(cfg_mod), 48000,
                                     2, num_render_channels=2)
    else:
        geo = chip_smoke.aec3_geometry(args.mode, args.pair_kernel)
    state = apm.init_state(geo, B)

    def step(f):
        nonlocal state
        sl = slice(f * frame, (f + 1) * frame)
        state, out, _, _ = apm.process_stream_pair(geo, state, cap[:, sl],
                                                   ren[:, sl])
        return out

    for f in range(warm):
        step(f)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in range(warm, warm + n):
        step(f)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / n
    ACTIVE[0] = True
    for f in range(warm, warm + n):
        step(f)
    ACTIVE[0] = False
    smi = chip_smoke.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(json.dumps({"event": "step", "batch": B, "mode": args.mode,
                      "aec3": not args.no_aec3,
                      "pair_kernel": geo.aec3 is not None
                      and geo.aec3.pair_kernel,
                      "ms_per_frame": step_ms, "card": smi}))
    print(json.dumps({"event": "stages", "ms_per_frame": {
        k: v * 1e3 / n for k, v in sorted(TIMES.items(),
                                          key=lambda kv: -kv[1])}}))

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in range(warm + n, warm + n + 4):
            step(f)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels, dev_us = 0, 0.0
    items = []
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels += ev.count
            dev_us += ev.self_device_time_total
            items.append((ev.self_device_time_total / 4e3, ev.count / 4,
                          ev.key[:80]))
    items.sort(reverse=True)
    print(json.dumps({"event": "profile", "frames": 4,
                      "kernels_per_frame": kernels / 4,
                      "device_ms_per_frame": dev_us / 4e3,
                      "wall_ms_per_frame": wall * 1e3 / 4,
                      "busy_share": dev_us / 1e6 / wall,
                      "top_device_items": items[:10]}))


if __name__ == "__main__":
    main()
