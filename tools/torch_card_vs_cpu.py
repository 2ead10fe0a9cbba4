"""The PyTorch port on the card against itself on the CPU, in lockstep.

    python3 tools/torch_card_vs_cpu.py [--frames 300] [--streams 0 2047]

Runs ``apm.process_stream_pair`` at the bench's 48 kHz stereo
configuration on the AEC3 echo scene of ``chip_smoke.py`` for the given
streams, on the card and on the CPU from the same initial state, and
prints one JSON line per event:

- ``first_divergence``: the first frame at which an AEC3 state leaf
  differs between the two by more than 1e-3 of its scale, with the five
  leaves that differ most (the first module whose state diverges);
- ``free_running``: the relative RMS of the outputs over all frames and
  per 50-frame window, and whether the delay estimates agree;
- ``reseeded``: the same comparison when the CPU restarts from the card's
  state before every frame (one-step error);
- ``sync_sites``: the source lines where one step synchronizes the host
  with the card (PyTorch's sync debug mode).

Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import warnings

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from webrtc_audio_processing_tpu_torch import apm, config as cfg_mod  # noqa


def _rel(a, b):
    return float(np.abs(a - b).max() / max(float(np.abs(b).max()), 1e-6))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--streams", type=int, nargs="+", default=[0, 2047])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    render, capture = chip_smoke.echo_scene(args.frames, chip_smoke.SEED,
                                            args.streams)
    geo = apm.ApmGeometry.create(chip_smoke.aec3_config(cfg_mod), 48000, 2,
                                 num_render_channels=2,
                                 aec3_stereo_content=True)
    S = len(args.streams)
    gpu = apm.init_state(geo, S)
    cpu = apm.init_state(geo, S, device="cpu")
    outs = {"gpu": [], "cpu": [], "reseeded": []}
    dly = {"gpu": [], "cpu": [], "reseeded": []}
    first = None
    for f in range(args.frames):
        sl = slice(f * 480, (f + 1) * 480)
        c, r = torch.from_numpy(capture[:, sl].copy()), torch.from_numpy(
            render[:, sl].copy())
        seed_state = chip_smoke.select_streams(gpu, torch.arange(S, device=dev),
                                               "cpu")
        _, y1, _, s1 = apm.process_stream_pair(geo, seed_state, c, r)
        gpu, y, _, sg = apm.process_stream_pair(geo, gpu, c.to(dev),
                                                r.to(dev))
        cpu, yc, _, sc = apm.process_stream_pair(geo, cpu, c, r)
        outs["gpu"].append(y.cpu().numpy())
        outs["cpu"].append(yc.numpy())
        outs["reseeded"].append(y1.numpy())
        dly["gpu"].append(sg["delay_ms"].cpu().numpy())
        dly["cpu"].append(sc["delay_ms"].numpy())
        dly["reseeded"].append(s1["delay_ms"].numpy())
        if first is None:
            g, k = apm.state_to_numpy(gpu), apm.state_to_numpy(cpu)
            devs = sorted(((_rel(g[n], k[n]), n) for n in g
                           if n.startswith("aec.") and g[n].size
                           and g[n].dtype.kind not in "b"), reverse=True)
            if devs and devs[0][0] > 1e-3:
                first = f
                print(json.dumps({"event": "first_divergence", "frame": f,
                                  "leaves": devs[:5]}), flush=True)

    def report(name, a, b, da, db):
        a, b = np.concatenate(a, axis=1), np.concatenate(b, axis=1)
        err = (a - b) ** 2
        rel = np.sqrt(err.sum(axis=(1, 2)) / (b ** 2).sum(axis=(1, 2)))
        win = []
        for w0 in range(0, a.shape[1], 50 * 480):
            s = slice(w0, w0 + 50 * 480)
            win.append(np.sqrt(err[:, s].sum(axis=(1, 2))
                               / (b[:, s] ** 2).sum(axis=(1, 2))).tolist())
        print(json.dumps({"event": name, "rel_rms": rel.tolist(),
                          "rel_rms_per_50_frames": win,
                          "delay_equal": bool((np.stack(da)
                                               == np.stack(db)).all())}),
              flush=True)

    report("free_running", outs["gpu"], outs["cpu"], dly["gpu"], dly["cpu"])
    report("reseeded", outs["gpu"], outs["reseeded"], dly["gpu"],
           dly["reseeded"])

    sites = collections.Counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        sl = slice(0, 480)
        apm.process_stream_pair(geo, gpu,
                                torch.from_numpy(capture[:, sl].copy()).to(dev),
                                torch.from_numpy(render[:, sl].copy()).to(dev))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("default")
    for w in caught:
        if chip_smoke.SYNC_WARNING in str(w.message):
            sites[f"{os.path.relpath(w.filename, REPO)}:{w.lineno}"] += 1
    print(json.dumps({"event": "sync_sites", "sites": dict(sites)}))


if __name__ == "__main__":
    main()
