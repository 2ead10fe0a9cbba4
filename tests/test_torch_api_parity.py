"""The port's ``api.AudioProcessing`` against the JAX package's on the CPU.

One module-scoped run of each: 16 kHz mono with HPF, AEC3, NS and AGC2
(adaptive digital and the input volume controller), 12 frames of an echo
scene on the banded path (``process_reverse_stream`` then
``process_stream``), the applied volume fed back from each one's
recommendation. Per frame: relative RMS <= 1e-3 (BASELINE.md), the same
delay and the same recommended volume. The first frame's output is AEC3's
start-up silence (~1e-9 in [-1, 1], float noise far below one int16 step),
where a relative bar measures nothing: a frame whose RMS is under one
int16 step (1/32768) is held to 1e-3 of that step.
"""

import numpy as np
import pytest

from tests import torch_threads  # noqa: F401  (one thread a worker)
from webrtc_audio_processing_tpu import api as j_api
from webrtc_audio_processing_tpu import config as j_cfg

from webrtc_audio_processing_tpu_torch import api
from webrtc_audio_processing_tpu_torch import config as cfg_mod

N_FRAMES = 12
RATE = 16000
FRAME = RATE // 100
RTOL_RMS = 1e-3
RMS_FLOOR = 1.0 / 32768.0  # one int16 step in [-1, 1]


def config(m):
    return m.Config().replace(
        high_pass_filter=m.HighPassFilter(enabled=True),
        echo_canceller=m.EchoCanceller(enabled=True),
        noise_suppression=m.NoiseSuppression(enabled=True),
        gain_controller2=m.GainController2(
            enabled=True, adaptive_digital=m.AdaptiveDigital(enabled=True),
            input_volume_controller=m.InputVolumeController(enabled=True)),
    )


def scene(n_frames, seed, rate=RATE, channels=1):
    """Far-end noise bursts and the near end: their echo (5 ms late) plus
    -40 dBFS noise, (n, channels) float32 each."""
    rng = np.random.default_rng(seed)
    n = n_frames * rate // 100
    burst = (np.sin(2 * np.pi * 2.3 * np.arange(n) / rate) > -0.2)
    far = 0.2 * burst * rng.standard_normal(n)
    far = np.repeat(far[:, None], channels, axis=1)
    near = 0.4 * np.roll(far, rate // 200, axis=0) + 0.01 * (
        rng.standard_normal((n, channels)))
    return far.astype(np.float32), near.astype(np.float32)


def run(ap, far, near, frames, rate=RATE):
    """Reverse then capture, frame by frame; the applied volume is the
    last recommendation."""
    frame = rate // 100
    out = {"out": [], "render_out": [], "delay": [], "level": [],
           "linear": [], "flip": None}
    level = 100
    for k in range(frames):
        sl = slice(k * frame, (k + 1) * frame)
        ap.set_stream_analog_level(level)
        err, rout = ap.process_reverse_stream(far[sl], rate)
        assert err == 0
        err, y = ap.process_stream(near[sl], rate)
        assert err == 0
        level = ap.recommended_stream_analog_level()
        out["out"].append(np.asarray(y))
        out["render_out"].append(np.asarray(rout))
        out["delay"].append(ap.get_statistics().delay_ms)
        out["level"].append(level)
        out["linear"].append(np.asarray(ap.get_linear_aec_output()))
        if ap._aec3_stereo_active and out["flip"] is None:
            out["flip"] = k
    out["stats"] = vars(ap.get_statistics())
    out["proc"] = (ap.proc_sample_rate_hz(), ap.num_bands())
    return out


@pytest.fixture(scope="module")
def runs():
    far, near = scene(N_FRAMES, seed=7)
    return (run(j_api.AudioProcessing(config(j_cfg)), far, near, N_FRAMES),
            run(api.AudioProcessing(config(cfg_mod), device="cpu"), far, near,
                N_FRAMES))


def _rel_rms(got, want):
    err = np.sqrt(np.mean((got - want) ** 2))
    return err / max(np.sqrt(np.mean(want ** 2)), RMS_FLOOR)


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_frame_matches_jax(runs, frame):
    want, got = runs
    assert _rel_rms(got["out"][frame], want["out"][frame]) <= RTOL_RMS
    assert got["delay"][frame] == want["delay"][frame]
    assert got["level"][frame] == want["level"][frame]
    np.testing.assert_allclose(got["render_out"][frame],
                               want["render_out"][frame], rtol=0, atol=1e-6)


def test_linear_aec_output_matches_jax(runs):
    want, got = runs
    for g, w in zip(got["linear"], want["linear"]):
        assert g.shape == w.shape == (1, FRAME)
        assert _rel_rms(g, w) <= RTOL_RMS


def test_statistics_match_jax(runs):
    """get_statistics() after the last frame: integer and boolean fields
    equal, float fields within 1e-4 of each field's scale
    (tests/test_torch_apm_default_48k.py's bar for the step's stats)."""
    want, got = runs[0]["stats"], runs[1]["stats"]
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert (g is None) == (w is None), k
        if w is None:
            continue
        if isinstance(w, (bool, int)):
            assert g == w, k
        else:
            assert abs(g - w) <= 1e-4 * max(abs(w), 1e-6), k
    assert runs[0]["proc"] == runs[1]["proc"] == (16000, 1)


@pytest.mark.slow
def test_stereo_content_flip_matches_jax():
    """48 kHz stereo with multichannel render: the render turns from
    identical channels to distinct ones, the content detector flips after
    its 2 s hysteresis, and both APIs rebuild AEC3 on the same frame (the
    detector kept, the canceller new). AEC3's float ties part free-running
    outputs after tens of frames (ROADMAP Queue 3), so the outputs are
    held to the bar over the first 20 frames."""
    frames, rate, held = 260, 48000, 20

    def cfg(m):
        return config(m).replace(pipeline=m.Pipeline(
            multi_channel_capture=True, multi_channel_render=True,
            maximum_internal_processing_rate=48000))

    far, near = scene(frames, seed=9, rate=rate, channels=2)
    rng = np.random.default_rng(10)
    start = 30 * rate // 100
    far[start:, 1] = 0.2 * rng.standard_normal(far.shape[0] - start)
    apis = (j_api.AudioProcessing(cfg(j_cfg)),
            api.AudioProcessing(cfg(cfg_mod), device="cpu"))
    want, got = (run(ap, far, near, frames, rate) for ap in apis)
    assert want["flip"] is not None and got["flip"] == want["flip"]
    for k in range(held):
        assert _rel_rms(got["out"][k], want["out"][k]) <= RTOL_RMS, k
        assert got["delay"][k] == want["delay"][k], k
