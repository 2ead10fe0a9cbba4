"""The mobile path's ERLE on chosen streams of ``chip_smoke.aecm_scene``,
JAX package against the port, on the CPU.

Both packages run the reference's fixed profile
(``chip_smoke.aecm_config``: HPF, NS, AECM in mobile mode, AGC1 adaptive
digital) at 16 kHz mono on the streams asked for, every stream reporting
``chip_smoke.AECM_DELAY_MS``; JAX's ``apm.process_stream_pair`` is vmapped
over them and compiled once. Each stream's ERLE is tests/test_aecm_apm.py's
measure (the far end's active samples) over the last third, as
``chip_smoke.aecm_fixed_phase`` takes it on the card, and the port's over
each 100-frame window beside it.

Run from the repo root (~2 min for 8 streams over 600 frames):

    JAX_PLATFORMS=cpu python -m tests.torch_aecm_erle_streams \\
        --ids 3628 630 1404 [--frames 600]

Prints one JSON object.
"""

import argparse
import json

import jax
import numpy as np
import torch

import chip_smoke
from tests.torch_agc1_util import batched, compile_all, t
from webrtc_audio_processing_tpu import apm as j_apm
from webrtc_audio_processing_tpu import config as j_cfg
from webrtc_audio_processing_tpu_torch import apm

RATE = 16000
FRAME = RATE // 100


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ids", type=int, nargs="+", required=True)
    ap.add_argument("--frames", type=int, default=chip_smoke.AECM_FRAMES)
    args = ap.parse_args(argv)
    ids, n_frames, B = args.ids, args.frames, len(args.ids)
    render, capture = chip_smoke.aecm_scene(n_frames, RATE, ids)
    geo = chip_smoke.aecm_geometry(RATE)
    jgeo = j_apm.ApmGeometry.create(chip_smoke.aecm_config(j_cfg), RATE, 1,
                                    render_input_rate=RATE,
                                    num_render_channels=1)
    delay = np.full(B, chip_smoke.AECM_DELAY_MS, np.int32)
    js = batched(j_apm.init_state(jgeo), B)
    step = compile_all({"step": (jax.vmap(
        lambda s, c, r, d: j_apm.process_stream_pair(
            jgeo, s, c, r, 0, stream_delay_ms=d)),
        (js, capture[:, :FRAME], render[:, :FRAME], delay))})["step"]
    state = apm.init_state(geo, B, device="cpu")
    outs = {"port": [], "jax": []}
    for f in range(n_frames):
        sl = slice(f * FRAME, (f + 1) * FRAME)
        state, y, _, _ = apm.process_stream_pair(
            geo, state, t(capture[:, sl]), t(render[:, sl]),
            stream_delay_ms=t(delay))
        js, jy, _, _ = step(js, capture[:, sl], render[:, sl], delay)
        outs["port"].append(y[:, :, 0])
        outs["jax"].append(t(np.asarray(jy)[:, :, 0]))

    def erle(out, sl):
        return chip_smoke._erle_active_db(
            t(capture[:, sl, 0]), t(render[:, sl, 0]), out[:, sl])

    tail = slice(-(n_frames // 3) * FRAME, None)
    result = {"streams": ids, "frames": n_frames,
              "stream_delay_ms": chip_smoke.AECM_DELAY_MS,
              "echo_delay_ms": [chip_smoke.AECM_ECHO_DELAYS_MS[s % 3]
                                for s in ids]}
    for name, o in outs.items():
        result[f"{name}_erle_db_last_third"] = [
            round(float(e), 2) for e in erle(torch.cat(o, 1), tail)]
    port = torch.cat(outs["port"], 1)
    result["port_erle_db_by_100_frames"] = [
        [round(float(e), 1) for e in erle(port, slice(w * 100 * FRAME,
                                                      (w + 1) * 100 * FRAME))]
        for w in range(n_frames // 100)]
    print(json.dumps(result))


if __name__ == "__main__":
    main()
