"""One API session of each package at 16 kHz mono (AEC3, NS, AGC2), shared
by the AEC dump and checkpoint tests of the port.

Each session runs 12 frames of an echo scene (``process_reverse_stream``
then ``process_stream``) with an AEC dump attached before the first frame
and ``checkpoint.save_stream`` before frame 6. The JAX session runs once
per process (``functools.lru_cache``), so the dump tests and the
checkpoint tests share its compiles when they run in one process: the
raw pair step of frame 0, the render step and the banded steps of both
parities, ~130 s with a cold JAX cache on one CPU (compiling them side by
side on a throwaway API saves nothing: XLA:CPU already spreads one
compile over the cores, and loading each from the persistent cache takes
5-10 s of tracing and loading).
"""

import atexit
import functools
import os
import shutil
import tempfile

import numpy as np

from tests import torch_threads  # noqa: F401  (one thread a worker)

N_FRAMES = 12
SAVE_AT = 6
RATE = 16000
FRAME = RATE // 100
RTOL_RMS = 1e-3  # BASELINE.md
RMS_FLOOR = 1.0 / 32768.0  # one int16 step in [-1, 1]


def config(m):
    """AEC3, NS and AGC2 with adaptive digital gain; ``m`` is either
    package's config module."""
    return m.Config().replace(
        echo_canceller=m.EchoCanceller(enabled=True),
        noise_suppression=m.NoiseSuppression(enabled=True),
        gain_controller2=m.GainController2(
            enabled=True, adaptive_digital=m.AdaptiveDigital(enabled=True)),
    )


def scene(n_frames=N_FRAMES, seed=11):
    """Far-end noise bursts and the near end: their echo (5 ms late) plus
    -40 dBFS noise, (n_frames, 160, 1) float32 each."""
    rng = np.random.default_rng(seed)
    n = n_frames * FRAME
    burst = np.sin(2 * np.pi * 2.3 * np.arange(n) / RATE) > -0.2
    far = 0.2 * burst * rng.standard_normal(n)
    near = 0.4 * np.roll(far, RATE // 200) + 0.01 * rng.standard_normal(n)
    return (far.astype(np.float32).reshape(n_frames, FRAME, 1),
            near.astype(np.float32).reshape(n_frames, FRAME, 1))


def rel_rms(got, want):
    """Relative RMS error, held to one int16 step where the reference is
    quieter than that (AEC3's start-up silence)."""
    err = np.sqrt(np.mean((got - want) ** 2))
    return err / max(np.sqrt(np.mean(want ** 2)), RMS_FLOOR)


def run_frames(ap, frames, far, near):
    """Reverse then capture for each frame index in ``frames``; the
    outputs stacked."""
    outs = []
    for k in frames:
        err, _ = ap.process_reverse_stream(far[k], RATE)
        assert err == 0
        err, y = ap.process_stream(near[k], RATE)
        assert err == 0
        outs.append(np.asarray(y))
    return np.stack(outs)


def _session(ap, ckpt_mod, tag):
    d = tempfile.mkdtemp(prefix=f"torch_api_{tag}_")
    atexit.register(shutil.rmtree, d, True)  # the files live with the process
    far, near = scene()
    dump = os.path.join(d, f"{tag}.aecdump")
    ckpt = os.path.join(d, f"{tag}_stream.npz")
    ap.attach_aec_dump(dump)
    first = run_frames(ap, range(SAVE_AT), far, near)
    ckpt_mod.save_stream(ckpt, ap)
    rest = run_frames(ap, range(SAVE_AT, N_FRAMES), far, near)
    ap.detach_aec_dump()
    return {"ap": ap, "dump": dump, "ckpt": ckpt, "far": far, "near": near,
            "out": np.concatenate([first, rest])}


@functools.lru_cache(maxsize=None)
def jax_session():
    """The JAX package's session; ``ap`` is its AudioProcessing after the
    12 frames."""
    from webrtc_audio_processing_tpu import api as j_api
    from webrtc_audio_processing_tpu import config as j_cfg
    from webrtc_audio_processing_tpu.utils import checkpoint as j_ckpt

    return _session(j_api.AudioProcessing(config(j_cfg)), j_ckpt, "jax")


@functools.lru_cache(maxsize=None)
def port_session():
    """The port's session on the CPU."""
    from webrtc_audio_processing_tpu_torch import api
    from webrtc_audio_processing_tpu_torch import config as cfg_mod
    from webrtc_audio_processing_tpu_torch.utils import checkpoint

    return _session(api.AudioProcessing(config(cfg_mod), device="cpu"),
                    checkpoint, "port")
