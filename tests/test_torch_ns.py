"""Parity of the port's noise suppressor with the JAX package on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests import torch_threads  # noqa: F401  (one thread a worker)
from webrtc_audio_processing_tpu.config import (
    NoiseSuppressionLevel as JLevel,
)
from webrtc_audio_processing_tpu.models import noise_suppressor as j_ns

from webrtc_audio_processing_tpu_torch.config import NoiseSuppressionLevel
from webrtc_audio_processing_tpu_torch.models import noise_suppressor as ns

B, C, BANDS = 2, 2, 3


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _bands(f, rng):
    """Speech-like band-0 tone bursts plus noise in every band, floatS16."""
    n = np.arange(160) + f * 160
    tone = 4000.0 * np.sin(2 * np.pi * 440.0 * n / 16000.0) * (f % 7 < 3)
    out = rng.standard_normal((B, BANDS, 160, C)) * 600.0
    out[:, 0] += tone[None, :, None]
    return out.astype(np.float32)


def _jax_state():
    st = j_ns.init_state(C, BANDS)
    return jax.tree_util.tree_map(lambda a: jnp.broadcast_to(a, (B,) + a.shape),
                                  st)


def _from_jax(jstate):
    return ns.NsState(**{
        f.name: _t(np.asarray(getattr(jstate, f.name)))
        for f in dataclasses.fields(ns.NsState)
    })


def _assert_state_close(state, jstate):
    for f in dataclasses.fields(ns.NsState):
        got = getattr(state, f.name).numpy()
        want = np.asarray(getattr(jstate, f.name))
        if want.dtype.kind in "iub":
            np.testing.assert_array_equal(got, want, err_msg=f.name)
        else:
            scale = max(float(np.abs(want).max()), 1e-6)
            np.testing.assert_allclose(got, want, rtol=1e-4,
                                       atol=1e-4 * scale, err_msg=f.name)


def test_ns_analyze_process_match_jax():
    """Output max_rel < 2e-3 over 60 frames (the bar of
    tests/test_noise_suppressor.py, crossing the 50-frame startup), and the
    state after 3 frames within 1e-4 of each leaf's scale."""
    params = j_ns.SUPPRESSION_PARAMS[JLevel.MODERATE]

    @jax.jit
    @jax.vmap
    def jstep(state, bands):
        state = j_ns.analyze(params, state, bands[0])
        return j_ns.process(params, state, bands)

    module = ns.NoiseSuppressor(NoiseSuppressionLevel.MODERATE)
    jstate = _jax_state()
    state = _from_jax(jstate)
    rng = np.random.default_rng(42)
    max_rel = 0.0
    for f in range(60):
        bands = _bands(f, rng)
        jstate, want = jstep(jstate, bands)
        state, got = module(state, _t(bands))
        want = np.asarray(want)
        scale = max(np.abs(want).max(), 1.0)
        max_rel = max(max_rel, np.abs(got.numpy() - want).max() / scale)
        if f == 2:
            _assert_state_close(state, jstate)
    assert max_rel < 2e-3, max_rel


def test_ns_zero_frames_keep_state_per_stream():
    """A stream whose frame and memory are all zero keeps its whole state
    (noise_suppressor.cc:294-318) while its neighbour advances."""
    params = j_ns.SUPPRESSION_PARAMS[JLevel.HIGH]
    module = ns.NoiseSuppressor(NoiseSuppressionLevel.HIGH)
    jstate = _jax_state()
    state = _from_jax(jstate)
    band0 = np.zeros((B, 160, C), np.float32)
    band0[1] = np.random.default_rng(0).standard_normal((160, C)) * 1000
    jstate = jax.jit(jax.vmap(lambda s, x: j_ns.analyze(params, s, x)))(
        jstate, band0)
    new = module.analyze(state, _t(band0))
    assert int(new.num_analyzed_frames[0]) == -1
    assert int(new.num_analyzed_frames[1]) == 0
    for f in dataclasses.fields(ns.NsState):
        np.testing.assert_array_equal(getattr(new, f.name)[0].numpy(),
                                      getattr(state, f.name)[0].numpy())
    _assert_state_close(new, jstate)
