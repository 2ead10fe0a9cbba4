"""Benchmark: concurrent real-time streams per card for the full APM.

The port's twin of the JAX package's ``bench.py``, run on one NVIDIA GPU:

    python3 -m webrtc_audio_processing_tpu_torch.bench

Prints ONE JSON line with ``bench.py``'s keys (``metric``, ``value``,
``unit``, ``vs_baseline``, ``secondary_16k_mono_streams``) and beside them
``card`` (``nvidia-smi``'s name and power limit), ``subtractor`` (``plain``
or ``k6``), ``ms_per_frame`` per mode and batch, and ``batches``: per mode
and batch the streams, the graph's capture seconds, device kernels per
frame (torch.profiler) and peak device memory.

The configuration, inputs and timing are ``bench.py``'s (:37-230): the two
``MODES``, multichannel AEC3 on stereo content, seed-0 white noise x 0.03,
chunks of 25 frame pairs with the block ordinals of ``n0s_for``, one warm
chunk and then the median of 5 repeats of two chunks in flight, streams =
B x min(10 ms / t, 1), the same batch sizes and early stop. Where the JAX
bench times one jitted ``lax.scan`` over the chunk, a chunk here is 25
replays of the pair step captured as one CUDA graph
(``step_graph.PairGraph``). Environment: ``BENCH_MODE`` (``both``,
``48k_stereo`` or ``16k_mono``), ``BENCH_TIME_BUDGET_S`` (900),
``BENCH_RING_DTYPE`` (``float32``, or ``bfloat16`` for AEC3's render
rings in bf16) and ``AEC3_PAIR_KERNEL``
(``1``: the subtractor on K6; the reference's plain one otherwise). Only an
out-of-memory error at a batch size is caught; any other error ends the run
with a non-zero exit and no result line.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from webrtc_audio_processing_tpu_torch import apm, config as cfg_mod
from webrtc_audio_processing_tpu_torch import step_graph
from webrtc_audio_processing_tpu_torch.models.aec3 import echo_canceller3

NORTH_STAR_STREAMS = 10000.0
METRIC = ("real-time 48 kHz stereo full-APM streams per chip (3-band QMF + "
          "multichannel AEC3 + NS + AGC2/RNN-VAD, 10 ms frames)")

MODES = {
    # mode: (rate, capture_ch, render_ch, max_internal_rate)
    "48k_stereo": (48000, 2, 2, 48000),
    "16k_mono": (16000, 1, 1, 32000),
}
BATCHES = {"48k_stereo": (512, 1024, 2048, 4096, 8192),
           "16k_mono": (1024, 4096, 8192, 16384)}
CHUNK_PAIRS = 25


def build_geometry(mode: str, pair_kernel: bool) -> apm.ApmGeometry:
    """``bench.build_step``'s configuration of ``mode`` (bench.py:37-79),
    the render rings in ``BENCH_RING_DTYPE``."""
    rate, cap_ch, ren_ch, max_internal = MODES[mode]
    c = cfg_mod.Config().replace(
        pipeline=cfg_mod.Pipeline(
            multi_channel_capture=cap_ch > 1,
            multi_channel_render=ren_ch > 1,
            maximum_internal_processing_rate=max_internal),
        high_pass_filter=cfg_mod.HighPassFilter(enabled=True),
        echo_canceller=cfg_mod.EchoCanceller(enabled=True),
        noise_suppression=cfg_mod.NoiseSuppression(enabled=True),
        gain_controller2=cfg_mod.GainController2(
            enabled=True,
            adaptive_digital=cfg_mod.AdaptiveDigital(enabled=True)),
    )
    return apm.ApmGeometry.create(
        c, rate, cap_ch, render_input_rate=rate, num_render_channels=ren_ch,
        aec3_stereo_content=ren_ch > 1,
        aec3_ring_dtype=os.environ.get("BENCH_RING_DTYPE", "float32"),
        aec3_pair_kernel=pair_kernel)


def card() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def device_kernels(warm, counted) -> float:
    """The device operations per call over the calls in ``counted``, by
    torch.profiler, after the calls in ``warm`` as the profiler's warm-up
    step, whose records it discards (sessions without one lost the device
    records of whole calls on the card's machine). The step's own range on
    the device (``ProfilerStep#``) is not an operation."""
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for calls in (warm, counted):
            for fn in calls:
                fn()
            torch.cuda.synchronize()
            prof.step()
    return sum(ev.count for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and not ev.key.startswith("ProfilerStep")) / len(counted)


def throughput(geo: apm.ApmGeometry, n_streams: int, rng, device) -> dict:
    """Seconds per 10 ms frame for ``n_streams`` (bench.py:140-193): the
    pair graph replayed over chunks of ``CHUNK_PAIRS`` pairs, two chunks in
    flight, the median of 5 repeats; beside it the capture's seconds, the
    peak device memory, the memory the graph's pool holds and the device
    kernels per frame."""
    frame = geo.capture_input_rate // 100
    cap_ch, ren_ch = geo.num_capture_channels, geo.num_render_channels
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    state = apm.init_state(geo, n_streams, device)
    graph = step_graph.PairGraph(geo, state)
    before = torch.cuda.memory_reserved(device)
    graph.capture()
    graph_bytes = torch.cuda.memory_reserved(device) - before

    ren = rng.standard_normal(
        (CHUNK_PAIRS, 2, n_streams, frame, ren_ch)).astype(np.float32) * 0.03
    cap = rng.standard_normal(
        (CHUNK_PAIRS, 2, n_streams, frame, cap_ch)).astype(np.float32) * 0.03
    # (pairs, [r0 c0 r1 c1], n, frame, ch)
    frames = torch.from_numpy(np.stack(
        [ren[:, 0], cap[:, 0], ren[:, 1], cap[:, 1]], axis=1)).to(device)
    del ren, cap

    def chunk(chunk_idx):
        # n0s_for (bench.py:177-179): the chunk's first ordinal; the graph
        # advances it by 5 a pair.
        graph.set_ordinal(5 * CHUNK_PAIRS * chunk_idx)
        for p in range(CHUNK_PAIRS):
            graph.replay(*frames[p].unbind(0))

    chunk(0)
    torch.cuda.synchronize(device)
    dts = []
    for rep in range(5):
        t0 = time.perf_counter()
        n_inflight = 2
        for j in range(n_inflight):
            chunk(rep * 8 + j + 1)
        torch.cuda.synchronize(device)
        dts.append((time.perf_counter() - t0)
                   / (2 * CHUNK_PAIRS * n_inflight))
    kernels = device_kernels([lambda: graph.replay(*frames[0].unbind(0))],
                             [lambda: graph.replay(*frames[1].unbind(0))] * 2)
    return dict(seconds_per_frame=float(np.median(dts)),
                capture_seconds=graph.capture_seconds,
                device_kernels_per_frame=kernels / 2,
                peak_memory_gb=torch.cuda.max_memory_allocated(device) / 1e9,
                graph_memory_gb=graph_bytes / 1e9)


def measure_streams(mode: str, budget_s: float, batch_sizes, run_batch):
    """bench.py's batch loop (:195-230) over ``run_batch(n) -> dict`` (with
    ``seconds_per_frame``): a batch size at or above one that ran out of
    device memory is skipped, the budget is checked before each batch once
    a result exists, and the loop stops when streams fall to 90% of the
    best. Returns (best streams, {n: the batch's dict with its streams})."""
    t_start = time.perf_counter()
    best_streams = 0
    results = {}
    min_failed_n = None
    for n in batch_sizes:
        if best_streams and time.perf_counter() - t_start > budget_s:
            print(f"# [{mode}] budget exhausted before n={n}",
                  file=sys.stderr)
            break
        if min_failed_n is not None and n >= min_failed_n:
            print(f"# [{mode}] n={n} skipped (>= failed n={min_failed_n})",
                  file=sys.stderr)
            continue
        try:
            res = run_batch(n)
        except torch.cuda.OutOfMemoryError as e:
            print(f"# [{mode}] n={n} out of device memory: {e}",
                  file=sys.stderr)
            min_failed_n = n if min_failed_n is None else min(min_failed_n, n)
            continue
        finally:
            # The batch's state, graph and frames go before the next.
            gc.collect()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
        dt = res["seconds_per_frame"]
        streams = int(n * min(0.010 / dt, 1.0))
        results[n] = dict(res, streams=streams)
        print(f"# [{mode}] n={n}: {dt*1e3:.2f} ms/frame -> {streams} "
              "rt streams", file=sys.stderr)
        if streams <= best_streams * 0.9:
            break
        best_streams = max(best_streams, streams)
    return best_streams, results


def result_line(headline, secondary, results: dict, card_name: str,
                pair_kernel: bool) -> dict:
    """The one JSON line: bench.py's keys (:277-287) and the card's."""
    out = {
        "metric": METRIC,
        "value": headline,
        "unit": "streams",
        "vs_baseline": headline / NORTH_STAR_STREAMS,
    }
    if secondary is not None:
        out["secondary_16k_mono_streams"] = secondary
    out["card"] = card_name
    out["subtractor"] = "k6" if pair_kernel else "plain"
    out["ms_per_frame"] = {
        mode: {str(n): r["seconds_per_frame"] * 1e3 for n, r in res.items()}
        for mode, res in results.items()}
    out["batches"] = {
        mode: {str(n): {k: v for k, v in r.items()
                        if k != "seconds_per_frame"} for n, r in res.items()}
        for mode, res in results.items()}
    return out


def run_mode(mode: str, budget_s: float, pair_kernel: bool, device):
    geo = build_geometry(mode, pair_kernel)
    rng = np.random.default_rng(0)
    return measure_streams(mode, budget_s, BATCHES[mode],
                           lambda n: throughput(geo, n, rng, device))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device (torch.cuda.is_available() "
                         "is false); the benchmark runs on the card")
    budget_s = float(os.environ.get("BENCH_TIME_BUDGET_S", "900"))
    mode = os.environ.get("BENCH_MODE", "both")
    if mode not in ("both", *MODES):
        raise SystemExit(f"bench: BENCH_MODE {mode!r} is not both, "
                         f"{' or '.join(MODES)}")
    pair_kernel = echo_canceller3.pair_kernel_from_env()
    device = torch.device("cuda", 0)
    card_name = card()
    t0 = time.perf_counter()

    headline = 0
    secondary = None
    results = {}
    if mode in ("both", "48k_stereo"):
        headline, results["48k_stereo"] = run_mode(
            "48k_stereo", budget_s * 0.75, pair_kernel, device)
    if mode in ("both", "16k_mono"):
        remaining = budget_s - (time.perf_counter() - t0)
        if mode == "16k_mono" or remaining > 120:
            secondary, results["16k_mono"] = run_mode(
                "16k_mono", max(remaining, 60), pair_kernel, device)
    print(json.dumps(result_line(headline, secondary, results, card_name,
                                 pair_kernel)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
