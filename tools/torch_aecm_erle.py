"""ERLE of the mobile path on ``chip_smoke.aecm_scene``, on the CPU.

Runs the reference's fixed profile (``chip_smoke.aecm_geometry(16000)``:
HPF, NS, AECM in mobile mode, AGC1 adaptive digital) eagerly on the CPU
over the scene chip_smoke.py's ``aecm_fixed_16k`` phase plays on the card,
at a small batch, with every stream reporting one stream delay, and prints
each stream's ERLE over the last third (tests/test_aecm_apm.py's measure:
the far end's active samples), its echo delay and AECM's delay estimate.
Streams s carry an echo ``chip_smoke.AECM_ECHO_DELAYS_MS[s % 3]`` late;
the odd ones a talker too.

    python3 tools/torch_aecm_erle.py [--frames 600] [--delay-ms 20] \\
        [--first 0] [--streams 12]           # CPU, ~4 min at 600 frames
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from webrtc_audio_processing_tpu_torch import apm  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=chip_smoke.AECM_FRAMES)
    ap.add_argument("--delay-ms", type=int, default=chip_smoke.AECM_DELAY_MS)
    ap.add_argument("--first", type=int, default=0)
    ap.add_argument("--streams", type=int, default=12)
    args = ap.parse_args(argv)
    B, n_frames = args.streams, args.frames
    geo = chip_smoke.aecm_geometry(16000)
    streams = range(args.first, args.first + B)
    render, capture = chip_smoke.aecm_scene(n_frames, 16000, streams)
    state = apm.init_state(geo, B, device="cpu")
    delay = torch.full((B,), args.delay_ms, dtype=torch.int32)
    outs = []
    for f in range(n_frames):
        sl = slice(160 * f, 160 * (f + 1))
        state, out, _, _ = apm.process_stream_pair(
            geo, state, torch.from_numpy(capture[:, sl]),
            torch.from_numpy(render[:, sl]), stream_delay_ms=delay)
        outs.append(out[:, :, 0])
    tail = n_frames // 3 * 160
    erle = chip_smoke._erle_active_db(
        torch.from_numpy(capture[:, -tail:, 0]),
        torch.from_numpy(render[:, -tail:, 0]), torch.cat(outs, 1)[:, -tail:])
    print(json.dumps({
        "frames": n_frames, "stream_delay_ms": args.delay_ms,
        "streams": list(streams),
        "echo_delay_ms": [chip_smoke.AECM_ECHO_DELAYS_MS[s % 3]
                          for s in streams],
        "talker": [s % 2 == 1 for s in streams],
        "erle_db": [round(float(e), 2) for e in erle],
        "aecm_delay_blocks": state.aecm.core.delay_estimator.last_delay
        .reshape(-1).tolist()}))


if __name__ == "__main__":
    main()
