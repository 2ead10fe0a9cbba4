"""The hybrid AGC1's level under residual echo, JAX package against the
port, on the CPU: does the analog level rise from 100 on a quiet voiced
near end that shares the capture with echo?

The scene is ``chip_smoke.agc1_hybrid_phase``'s at 16 kHz mono: the echo
scene of streams 4094 and 4095 (``chip_smoke.echo_scene``, its seed), 300
frames played twice, with ``chip_smoke.voiced_near_end`` added to stream
4095's capture at each amplitude asked for (one row each) and stream 4094
left echo only. Both packages run ``Config()`` with HPF, AEC3, NS and
``GainController1(enabled=True)``, the applied volume starting at 100 and
taking frame 1's recommended level between pairs, as the chip phase closes
the loop. JAX's ``apm.process_stream_pair`` is vmapped over the rows and
compiled at the six static parities of the period.

Run from the repo root (~6 min with a cold JAX cache on 8 CPU cores):

    JAX_PLATFORMS=cpu python -m tests.torch_agc1_voice_level \\
        [--amps 0.02 0.05 0.1] [--frames 600]

Prints one JSON object: per row, each package's level every 30 frames,
its last level and the first frame whose level differs from 100.
"""

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke
from tests.torch_agc1_util import batched, compile_all, t
from webrtc_audio_processing_tpu import apm as j_apm
from webrtc_audio_processing_tpu import config as j_cfg
from webrtc_audio_processing_tpu_torch import apm
from webrtc_audio_processing_tpu_torch import config as cfg_mod

RATE = 16000
FRAME = RATE // 100
REC = "agc1_recommended_level"


def config(m):
    return m.Config().replace(
        high_pass_filter=m.HighPassFilter(enabled=True),
        echo_canceller=m.EchoCanceller(enabled=True),
        noise_suppression=m.NoiseSuppression(enabled=True),
        gain_controller1=m.GainController1(enabled=True))


def scene(amps, n_frames):
    """Rows: stream 4095 with the voice at each of ``amps``, then stream
    4094 echo only. Returns (render, capture, names), (rows, n, 1)."""
    scene_frames = chip_smoke.AEC3_FRAMES
    render, capture = chip_smoke.echo_scene(scene_frames, chip_smoke.SEED,
                                            [4094, 4095], RATE, 1)
    reps = -(-n_frames // scene_frames)
    render = np.tile(render, (1, reps, 1))[:, :n_frames * FRAME]
    capture = np.tile(capture, (1, reps, 1))[:, :n_frames * FRAME]
    voice = chip_smoke.voiced_near_end(scene_frames * FRAME, RATE,
                                       chip_smoke.SEED, 1.0)
    voice = np.tile(voice, reps)[:n_frames * FRAME]
    rows_r = [render[1]] * len(amps) + [render[0]]
    rows_c = [capture[1] + a * voice[:, None] for a in amps] + [capture[0]]
    names = [f"4095 voice {a}" for a in amps] + ["4094 echo only"]
    return (np.stack(rows_r).astype(np.float32),
            np.stack(rows_c).astype(np.float32), names)


def run(amps, n_frames):
    render, capture, names = scene(amps, n_frames)
    rows = len(names)
    jgeo = j_apm.ApmGeometry.create(config(j_cfg), RATE, 1)
    geo = apm.ApmGeometry.create(config(cfg_mod), RATE, 1)
    js = batched(j_apm.init_state(jgeo), rows)
    steps = compile_all({ph: (jax.vmap(
        lambda s, c, r, v, n0, ph=ph: j_apm.process_stream_pair(
            jgeo, s, c, r, ph, applied_input_volume=v, n0=n0),
        in_axes=(0, 0, 0, 0, None)), (js, capture[:, :FRAME],
                                      render[:, :FRAME],
                                      jnp.zeros(rows, jnp.int32),
                                      jnp.int32(0)))
        for ph in range(apm.parity_period(geo))})
    state = apm.init_state(geo, rows, device="cpu")
    j_vol = np.full(rows, 100, np.int32)
    p_vol = torch.full((rows,), 100, dtype=torch.int32)
    j_levels, p_levels = [], []
    with torch.inference_mode():
        for f in range(n_frames):
            sl = slice(f * FRAME, (f + 1) * FRAME)
            js, _, _, jst = steps[f % 6](js, capture[:, sl], render[:, sl],
                                         jnp.asarray(j_vol),
                                         jnp.int32(apm.block_ordinal(f)))
            state, _, _, st = apm.process_stream_pair(
                geo, state, t(capture[:, sl]), t(render[:, sl]),
                applied_input_volume=p_vol)
            j_levels.append(np.asarray(jst[REC]))
            p_levels.append(st[REC].numpy().copy())
            if f % 2:  # between pairs, as the chip phase closes the loop
                j_vol = j_levels[-1].astype(np.int32)
                p_vol = st[REC].clone()
    out = {}
    for name, levels in (("jax", j_levels), ("torch", p_levels)):
        lv = np.stack(levels, axis=1).astype(int)  # (rows, frames)
        moved = [np.flatnonzero(r != 100) for r in lv]
        out[name] = {n: {"track_every_30": r[::30].tolist(),
                         "last": int(r[-1]),
                         "first_moved_frame": (int(m[0]) if m.size
                                               else None)}
                     for n, r, m in zip(names, lv, moved)}
    diff = np.abs(np.stack(j_levels, 1).astype(int)
                  - np.stack(p_levels, 1).astype(int))
    out["max_abs_level_diff"] = dict(zip(names, diff.max(axis=1).tolist()))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--amps", type=float, nargs="+",
                    default=[0.02, 0.05, 0.1])
    ap.add_argument("--frames", type=int, default=600)
    a = ap.parse_args()
    print(json.dumps({"scene": "16 kHz mono, streams 4094/4095",
                      "frames": a.frames, **run(a.amps, a.frames)}))


if __name__ == "__main__":
    main()
