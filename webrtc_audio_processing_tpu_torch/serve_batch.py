"""Batched multi-stream serving example.

The port's twin of the repository's ``examples/serve_batch.py``: N
independent APM streams (AEC3, NS, AGC2 with adaptive digital gain) as one
batch, per-stream state batched on the leading axis, frames arriving as
(N, frame, channels) tensors, and the pair step (two frames) captured as
one CUDA graph (``step_graph.PairGraph``) that advances every stream.
With ``--shards S`` the stream axis is split into S shards, one a card
round-robin, each its own pair graph on its own CUDA stream
(``graft_entry.ShardedPairStep``): streams are independent, so the shards
share nothing. ``--cpu`` runs the shards eagerly on the CPU instead.

Usage:
  python -m webrtc_audio_processing_tpu_torch.serve_batch [--streams 64]
      [--frames 100] [--rate 16000] [--channels 1] [--shards 1] [--cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def geometry(rate: int, channels: int):
    """``examples/serve_batch.py``'s configuration."""
    from webrtc_audio_processing_tpu_torch import apm, config as cfg_mod

    c = cfg_mod.Config().replace(
        echo_canceller=cfg_mod.EchoCanceller(enabled=True),
        noise_suppression=cfg_mod.NoiseSuppression(enabled=True),
        gain_controller2=cfg_mod.GainController2(
            enabled=True,
            adaptive_digital=cfg_mod.AdaptiveDigital(enabled=True)),
    )
    return apm.ApmGeometry.create(c, rate, channels, render_input_rate=rate,
                                  num_render_channels=channels)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--streams", type=int, default=64)
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--rate", type=int, default=16000)
    ap.add_argument("--channels", type=int, default=1)
    ap.add_argument("--shards", type=int, default=1,
                    help="split the stream axis into this many shards, one "
                         "a card round-robin")
    ap.add_argument("--cpu", action="store_true",
                    help="run the shards eagerly on the CPU")
    args = ap.parse_args(argv)

    from webrtc_audio_processing_tpu_torch import apm, graft_entry

    geo = geometry(args.rate, args.channels)
    frame = args.rate // 100
    n = args.streams
    devices = (["cpu"] * args.shards if args.cpu
               else graft_entry.default_devices(args.shards))
    t0 = time.time()
    runner = graft_entry.ShardedPairStep(
        geo, apm.init_state(geo, n, devices[0]), devices)
    runner.capture()
    if args.shards > 1:
        print(f"sharding {n} streams over {args.shards} shards on "
              f"{len({str(d) for d in runner.devices})} devices")

    rng = np.random.default_rng(0)
    processed = None
    for _ in range(0, args.frames, 2):
        r0, c0, r1, c1 = (
            torch.from_numpy(rng.standard_normal(
                (n, frame, args.channels)).astype(np.float32) * 1000).to(
                    runner.out_device)
            for _ in range(4))
        _, (processed, _) = runner.step(r0, c0, r1, c1)
    if runner.cuda:
        torch.cuda.synchronize(runner.out_device)
    dt = time.time() - t0
    if processed is not None and not bool(torch.isfinite(processed).all()):
        raise AssertionError("non-finite output")
    audio_s = args.frames * 0.010 * n
    print(f"{n} streams x {args.frames} frames: {dt:.2f}s wall "
          f"({audio_s / dt:.0f}x real-time aggregate, set-up and graph "
          "capture included)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
