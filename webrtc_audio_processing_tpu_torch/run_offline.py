"""Offline APM runner: a near/far WAV pair in, the processed WAV out.

The port's twin of ``examples/run_offline.py``: paired 10 ms frames through
``api.AudioProcessing`` (AEC3, NS and AGC2 by default), on the card unless
``--device cpu`` says otherwise, the processed capture written as a WAV.

    python -m webrtc_audio_processing_tpu_torch.run_offline near.wav out.wav \\
        [--far far.wav] [--no-aec] [--no-ns] [--no-agc2] \\
        [--stream-delay-ms N] [--device cpu]

``--aecm`` (the mobile echo canceller) raises: it is not ported yet.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _frames_first(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x)
    if x.ndim == 1:
        x = x[:, None]
    return x.T if x.shape[0] < x.shape[1] else x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("near", help="capture (near-end) WAV")
    ap.add_argument("out", help="output WAV")
    ap.add_argument("--far", help="render (far-end) WAV for echo control")
    ap.add_argument("--no-aec", action="store_true")
    ap.add_argument("--no-ns", action="store_true")
    ap.add_argument("--no-agc2", action="store_true")
    ap.add_argument("--aecm", action="store_true",
                    help="the mobile echo controller (not ported yet)")
    ap.add_argument("--stream-delay-ms", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; the card when not given")
    args = ap.parse_args(argv)
    if args.aecm:
        raise NotImplementedError(
            "the mobile echo canceller AECM is not ported yet (ROADMAP "
            "Queue 1 item 13b)")

    from webrtc_audio_processing_tpu_torch import config as cfg_mod
    from webrtc_audio_processing_tpu_torch.api import AudioProcessing
    from webrtc_audio_processing_tpu_torch.utils import wav_io

    near, fs = wav_io.read_wav(args.near)
    near = _frames_first(near)
    far = None
    if args.far:
        far, far_fs = wav_io.read_wav(args.far)
        far = _frames_first(far)
        if far_fs != fs:
            raise ValueError("near and far sample rates must match")

    c = cfg_mod.Config().replace(
        echo_canceller=cfg_mod.EchoCanceller(
            enabled=not args.no_aec and far is not None),
        noise_suppression=cfg_mod.NoiseSuppression(enabled=not args.no_ns),
        gain_controller2=cfg_mod.GainController2(
            enabled=not args.no_agc2,
            adaptive_digital=cfg_mod.AdaptiveDigital(
                enabled=not args.no_agc2)),
    )
    apm = AudioProcessing(c, device=args.device)
    apm.set_stream_delay_ms(args.stream_delay_ms)

    frame = fs // 100
    n_frames = near.shape[0] // frame
    outs = []
    t0 = time.perf_counter()
    for k in range(n_frames):
        sl = slice(k * frame, (k + 1) * frame)
        if far is not None:
            apm.process_reverse_stream(far[sl], fs)
        err, out = apm.process_stream(near[sl], fs)
        if err != 0:
            print(f"frame {k}: error {err}", file=sys.stderr)
            return 1
        outs.append(out)
    dt = time.perf_counter() - t0

    wav_io.write_wav(args.out, np.concatenate(outs).astype(np.float32), fs)
    print(f"processed {n_frames} frames ({n_frames / 100.0:.1f} s audio) "
          f"in {dt:.1f} s on {apm.device} -> {args.out}")
    for key, v in sorted(vars(apm.get_statistics()).items()):
        if v is not None:
            print(f"  {key}: {v}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
