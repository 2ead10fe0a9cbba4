"""4 and 8 capture and render channels (the reference's maximum,
aec3/aec3_common.h:35-55) with multichannel AEC3 and the HPF at 16 kHz,
through the port's ``api.AudioProcessing`` on the CPU, as the JAX
package's tests/test_apm_channels_4_8.py runs them: at 4 x 4 against the
JAX package's API over 8 frames of an echo scene (``process_reverse_stream``
then ``process_stream``), relative RMS <= 1e-3 per frame (BASELINE.md) and
the same delay; at 8 x 8 the port alone, finite and of the right shape,
and against JAX under ``-m slow``, as JAX's own test marks its 8-channel
case.

Both APIs are initialized to the format before the first frame (their
``_ensure_initialized``, which the first ``process_stream`` would call),
so the first render frame takes the render step and every capture frame
the banded step; the JAX API's three steps then compile side by side,
once each (its state held free of weak types between calls).
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_threads  # noqa: F401  (one thread a worker)
from webrtc_audio_processing_tpu import api as j_api
from webrtc_audio_processing_tpu import config as j_cfg

from webrtc_audio_processing_tpu_torch import api, apm
from webrtc_audio_processing_tpu_torch import config as cfg_mod

RATE = 16000
FRAME = RATE // 100
N_FRAMES = 8
RTOL_RMS = 1e-3
RMS_FLOOR = 1.0 / 32768.0  # one int16 step in [-1, 1]


def config(m):
    return m.Config().replace(
        pipeline=m.Pipeline(multi_channel_capture=True,
                            multi_channel_render=True),
        echo_canceller=m.EchoCanceller(enabled=True),
        high_pass_filter=m.HighPassFilter(enabled=True),
    )


def scene(n_frames, channels, seed):
    """Far-end noise bursts, independent per channel, and the near end:
    each channel's echo of the far end's channel (5 ms late) plus a little
    of the next channel's, and -40 dBFS noise; (n, channels) float32."""
    rng = np.random.default_rng(seed)
    n = n_frames * FRAME
    burst = (np.sin(2 * np.pi * 2.3 * np.arange(n) / RATE) > -0.2)
    far = 0.2 * burst[:, None] * rng.standard_normal((n, channels))
    echo = np.roll(far, RATE // 200, axis=0)
    near = (0.4 * echo + 0.1 * np.roll(echo, 1, axis=1)
            + 0.01 * rng.standard_normal((n, channels)))
    return far.astype(np.float32), near.astype(np.float32)


def _strong(ap):
    """Strip the weak types off the JAX API's state. A step's output state
    carries other weak types than its input (values and dtypes equal), so
    each step would compile again for the state it meets on each frame;
    held strong, each compiles once."""
    ap._state = jax.tree_util.tree_map(lambda x: jnp.asarray(x, x.dtype),
                                       ap._state)


def _warm_jax(ap, far, near):
    """Compile the JAX API's render step and both banded capture steps side
    by side, with the arguments its calls pass (api.py:375, :457-463)."""
    _strong(ap)
    i32 = jnp.asarray(0, jnp.int32)
    ren, cap = jnp.asarray(far), jnp.asarray(near)
    bands = jax.eval_shape(ap._render_step, ap._state, ren)[2]
    jobs = [(ap._render_step, (ap._state, ren))] + [
        (step, (ap._state, cap, bands, i32, i32, i32))
        for step in ap._banded_steps]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        list(pool.map(lambda j: j[0].lower(*j[1]).compile(), jobs))


def run(ap, far, near, between=lambda ap: None):
    """Reverse then capture, frame by frame; ``between`` runs before each
    call."""
    outs, delays = [], []
    for f in range(far.shape[0] // FRAME):
        sl = slice(f * FRAME, (f + 1) * FRAME)
        between(ap)
        err, _ = ap.process_reverse_stream(far[sl], RATE)
        assert err == 0
        between(ap)
        err, out = ap.process_stream(near[sl], RATE)
        assert err == 0
        outs.append(np.asarray(out))
        delays.append(ap.get_statistics().delay_ms)
    return np.stack(outs), delays


def _both(channels):
    """(JAX API's run, the port API's run); the JAX steps compile while
    the port runs."""
    far, near = scene(N_FRAMES, channels, seed=channels)
    jap = j_api.AudioProcessing(config(j_cfg))
    jap._ensure_initialized(RATE, channels, RATE, channels)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        warm = pool.submit(_warm_jax, jap, far[:FRAME], near[:FRAME])
        ap = api.AudioProcessing(config(cfg_mod), device="cpu")
        ap._ensure_initialized(RATE, channels, RATE, channels)
        port = run(ap, far, near)
        warm.result()
    return run(jap, far, near, _strong), port


@pytest.fixture(scope="module")
def runs_4x4():
    return _both(4)


def _check_against_jax(runs, channels):
    (want, want_delay), (got, got_delay) = runs
    assert got.shape == want.shape == (N_FRAMES, FRAME, channels)
    assert np.isfinite(got).all()
    for f in range(N_FRAMES):
        err = np.sqrt(np.mean((got[f] - want[f]) ** 2))
        ref = max(np.sqrt(np.mean(want[f] ** 2)), RMS_FLOOR)
        assert err <= RTOL_RMS * ref, (f, err, ref)
    assert got_delay == want_delay


def test_4x4_api_matches_jax_api(runs_4x4):
    """Every frame within 1e-3 of the JAX API's output in relative RMS (a
    frame under one int16 step held to 1e-3 of that step: AEC3's start-up
    silence), the delays equal."""
    _check_against_jax(runs_4x4, 4)


def test_4x4_geometry_is_multichannel_aec3():
    """4 x 4 through the API; AEC3 cancels on all 4 capture channels and,
    as the reference's config selector does, takes the render side mono
    until it carries stereo content."""
    ap = api.AudioProcessing(config(cfg_mod), device="cpu")
    ap._ensure_initialized(RATE, 4, RATE, 4)
    geo = ap._geo
    assert (geo.num_capture_channels, geo.num_render_channels) == (4, 4)
    assert (geo.aec3.num_capture_channels,
            geo.aec3.num_render_channels) == (4, 1)
    assert geo.aec3_dynamic_stereo


def test_8x8_api_runs_finite():
    """The reference's maximum on the port's API alone: finite output of
    the right shape on every frame, the echo remover's state sized for 8
    capture channels."""
    far, near = scene(4, 8, seed=8)
    ap = api.AudioProcessing(config(cfg_mod), device="cpu")
    out, _ = run(ap, far, near)
    assert out.shape == (4, FRAME, 8)
    assert np.isfinite(out).all()
    assert ap._state.aec.remover.subtractor.refined.H.shape[1] == 8


def test_8x8_multichannel_aec3_runs_finite():
    """8 x 8 with the render side's stereo content detected: AEC3 on 8
    render channels, whose packed FFT and spectrum rows (K2's rows) are
    1,664 floats wide; 4 frames at B = 2, finite."""
    geo = apm.ApmGeometry.create(config(cfg_mod), RATE, 8,
                                 num_render_channels=8,
                                 aec3_stereo_content=True)
    assert (geo.aec3.num_capture_channels,
            geo.aec3.num_render_channels) == (8, 8)
    assert geo.aec3.buffer.sf_row_fp == 1664
    far, near = scene(4, 8, seed=9)
    state = apm.init_state(geo, 2, device="cpu")
    for f in range(4):
        sl = slice(f * FRAME, (f + 1) * FRAME)
        state, out, _, _ = apm.process_stream_pair(
            geo, state, torch.from_numpy(np.stack([near[sl]] * 2)),
            torch.from_numpy(np.stack([far[sl]] * 2)))
        assert tuple(out.shape) == (2, FRAME, 8)
        assert bool(torch.isfinite(out).all())


@pytest.mark.slow
def test_8x8_api_matches_jax_api():
    _check_against_jax(_both(8), 8)
