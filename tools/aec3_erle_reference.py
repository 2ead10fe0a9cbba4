"""ERLE of the JAX package and of the PyTorch port on the AEC3 echo scene.

    JAX_PLATFORMS=cpu python tools/aec3_erle_reference.py [--frames 300]

Runs ``apm.process_stream_pair`` of both packages on the CPU at the bench's
48 kHz stereo configuration (HPF, multichannel AEC3, NS, AGC2) over B = 2
streams of the echo scene that ``chip_smoke.py`` drives on the card
(``chip_smoke.echo_scene``, seeded), and prints each package's ERLE over
the last third, measured as ``tests/test_apm_48k_stereo.py`` measures it,
and the relative RMS between the two outputs. One JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--streams", type=int, nargs="+", default=[0, 2047])
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import torch

    import chip_smoke
    from webrtc_audio_processing_tpu import apm as j_apm
    from webrtc_audio_processing_tpu_torch import apm
    from tests.torch_aec3_setup import batched, geometries

    jgeo, geo = geometries()
    render, capture = chip_smoke.echo_scene(args.frames, chip_smoke.SEED,
                                            streams=args.streams)
    B = len(args.streams)
    steps = [jax.jit(jax.vmap(
        lambda s, c, r, n0, p=p: j_apm.process_stream_pair(
            jgeo, s, c, r, p, n0=n0), in_axes=(0, 0, 0, None)))
        for p in (0, 1)]
    js = batched(j_apm.init_state(jgeo), B)
    state = apm.state_from_jax(js, geo)
    jout, tout = [], []
    for f in range(args.frames):
        c = capture[:, f * 480:(f + 1) * 480]
        r = render[:, f * 480:(f + 1) * 480]
        js, jy, _, _ = steps[f % 2](js, c, r,
                                    jnp.int32(5 * (f // 2) + 2 * (f % 2)))
        state, y, _, _ = apm.process_stream_pair(
            geo, state, torch.from_numpy(c), torch.from_numpy(r))
        jout.append(np.asarray(jy))
        tout.append(y.numpy())
    jout = np.concatenate(jout, axis=1)
    tout = np.concatenate(tout, axis=1)
    erle_j = chip_smoke.erle_db(capture, render, jout)
    erle_t = chip_smoke.erle_db(capture, render, tout)
    rel = np.sqrt(((tout - jout) ** 2).sum(axis=(1, 2))
                  / (jout ** 2).sum(axis=(1, 2)))
    print(json.dumps({"streams": args.streams, "frames": args.frames,
                      "erle_db_jax": erle_j.tolist(),
                      "erle_db_port_cpu": erle_t.tolist(),
                      "rel_rms_port_vs_jax": rel.tolist()}))


if __name__ == "__main__":
    main()
