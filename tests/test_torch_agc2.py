"""Parity of the port's AGC2 chain (RNN-VAD, limiter, adaptive digital gain)
with the JAX package on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webrtc_audio_processing_tpu.config import (
    AdaptiveDigital as JAdaptiveDigital,
    GainController2 as JAgc2Config,
)
from webrtc_audio_processing_tpu.models.agc2 import adaptive_digital as j_ad
from webrtc_audio_processing_tpu.models.agc2 import gain_controller2 as j_gc2
from webrtc_audio_processing_tpu.models.agc2 import limiter as j_lim
from webrtc_audio_processing_tpu.models.agc2 import vad_wrapper as j_vad
from webrtc_audio_processing_tpu.models.agc2.rnn_vad import features as j_feat
from webrtc_audio_processing_tpu.models.agc2.rnn_vad import pitch as j_pitch
from webrtc_audio_processing_tpu.models.agc2.rnn_vad import rnn as j_rnn
from webrtc_audio_processing_tpu.ops import pallas_window as j_pw

from webrtc_audio_processing_tpu_torch.apm import state_to_numpy, tree_to_state
from webrtc_audio_processing_tpu_torch.config import (
    AdaptiveDigital,
    GainController2 as Agc2Config,
)
from webrtc_audio_processing_tpu_torch.models.agc2 import adaptive_digital as ad
from webrtc_audio_processing_tpu_torch.models.agc2 import gain_controller2 as gc2
from webrtc_audio_processing_tpu_torch.models.agc2 import limiter
from webrtc_audio_processing_tpu_torch.models.agc2 import vad_wrapper
from webrtc_audio_processing_tpu_torch.models.agc2.rnn_vad import (
    features,
    pitch,
    rnn,
)
from webrtc_audio_processing_tpu_torch.ops import cuda_window


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _batched(tree, b):
    return jax.tree_util.tree_map(lambda a: jnp.broadcast_to(a, (b,) + a.shape),
                                  tree)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree):
    return {jax.tree_util.keystr(p)[1:]: np.asarray(leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_states_close(state, jstate, rtol=1e-4):
    """Integer and boolean leaves exactly; float leaves within rtol of each
    leaf's scale."""
    got, want = state_to_numpy(state), _flat(jstate)
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if w.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            scale = max(float(np.abs(w).max()), 1e-6)
            np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol * scale,
                                       err_msg=k)


def _speech(n_frames, b, rate, seed, channels=1):
    """Harmonic tones with amplitude modulation plus noise, floatS16."""
    rng = np.random.default_rng(seed)
    n = rate // 100
    t = np.arange(n_frames * n)[None, :] / rate
    f0 = rng.uniform(100, 220, (b, 1))
    am = 0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(2, 5, (b, 1)) * t)
    sig = sum(np.sin(2 * np.pi * f0 * k * t) / k for k in range(1, 8)) * am
    x = 3000.0 * sig[:, :, None] + 300.0 * rng.standard_normal(
        (b, n_frames * n, channels))
    return x.astype(np.float32).reshape(b, n_frames, n, channels).transpose(
        1, 0, 2, 3)


# ------------------------------------------------------------- pitch


def test_pitch_periods_match_exactly():
    b = 6
    bufs = _speech(4, b, 24000, 7)[:, :, :, 0].transpose(1, 0, 2).reshape(
        b, -1)[:, :864]
    last_period = np.array([0, 100, 200, 300, 400, 500], np.int32)
    last_strength = np.linspace(0.0, 0.9, b).astype(np.float32)
    jp, js = jax.jit(jax.vmap(j_pitch.estimate_pitch))(bufs, last_period,
                                                       last_strength)
    p, s = pitch.estimate_pitch(_t(bufs), _t(last_period), _t(last_strength))
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------- features, K5


def test_k5_twin_matches_dynamic_slice_exactly():
    rng = np.random.default_rng(3)
    b = 16
    buf = rng.standard_normal((b, 864)).astype(np.float32)
    start = rng.integers(0, 385, b).astype(np.int32)
    start[:3] = (-7, 384, 1000)  # clamped as lax.dynamic_slice clamps
    want = jax.jit(jax.vmap(j_pw.make_take_window(480)))(buf, start)
    got = cuda_window.take_windows(_t(buf), _t(start), 480)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert cuda_window.launches == 0  # the CPU path never launches K5


def test_features_match():
    b = 4
    frames = _speech(5, b, 24000, 5)[:, :, :, 0]
    step = jax.jit(jax.vmap(j_feat.extract_features))
    jstate = _batched(j_feat.init_state(), b)
    state = tree_to_state(features.init_state(1, "cpu"), _np(jstate))
    module = features.FeatureExtractor()
    for frame in frames:
        jstate, jfeat, jsil = step(jstate, frame)
        state, feat, sil = module(state, _t(frame))
        np.testing.assert_array_equal(sil.numpy(), np.asarray(jsil))
        scale = float(np.abs(np.asarray(jfeat)).max())
        np.testing.assert_allclose(feat.numpy(), np.asarray(jfeat), rtol=1e-4,
                                   atol=1e-4 * scale)
        _assert_states_close(state, jstate)


# ------------------------------------------------------------- RNN, VAD


def test_rnn_weights_load_as_the_jax_package_loads_them():
    want = j_rnn.get_weights()
    module = rnn.RnnVad()
    for name, w in want.items():
        np.testing.assert_array_equal(getattr(module, name).numpy(),
                                      np.asarray(w), err_msg=name)


def test_rnn_probability_matches():
    rng = np.random.default_rng(9)
    b = 8
    feats = (rng.standard_normal((b, 42)) * 2).astype(np.float32)
    gru = rng.uniform(0, 1, (b, 24)).astype(np.float32)
    silence = np.array([False] * 7 + [True])
    jst, jprob = jax.jit(jax.vmap(j_rnn.compute_vad_probability))(
        j_rnn.RnnState(gru=gru), feats, silence)
    st, prob = rnn.RnnVad()(rnn.RnnState(gru=_t(gru)), _t(feats), _t(silence))
    np.testing.assert_allclose(prob.numpy(), np.asarray(jprob), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(st.gru.numpy(), np.asarray(jst.gru), rtol=0,
                               atol=1e-4)


def test_vad_wrapper_matches_through_reset():
    """Starts with time_to_reset = 2, so the GRU reset runs on frame 2."""
    b = 3
    jstate = _batched(j_vad.init_state(48000), b)
    jstate = jstate.replace(time_to_reset=jnp.full((b,), 2, jnp.int32))
    state = tree_to_state(vad_wrapper.init_state(48000, 1, "cpu"), _np(jstate))
    module = vad_wrapper.VadWrapper(48000)
    step = jax.jit(jax.vmap(lambda s, x: j_vad.analyze(s, x, 48000)))
    for f, frame in enumerate(_speech(6, b, 48000, 2, channels=2)):
        jstate, jprob = step(jstate, frame)
        state, prob = module(state, _t(frame))
        np.testing.assert_allclose(prob.numpy(), np.asarray(jprob), rtol=0,
                                   atol=1e-4)
        if f == 1:
            assert (state.time_to_reset == 150).all()
    _assert_states_close(state, jstate)


# ------------------------------------------------------------- limiter, AD


def test_limiter_matches():
    b = 4
    rng = np.random.default_rng(4)
    jstate = _batched(j_lim.init_state(), b)
    state = tree_to_state(limiter.init_state(1, "cpu"), _np(jstate))
    module = limiter.Limiter()
    step = jax.jit(jax.vmap(j_lim.process))
    for f in range(6):
        level = np.array([1000.0, 20000.0, 33000.0, 60000.0])[:, None, None]
        x = (level * np.sin(np.arange(480) / 7.0 + f)[None, :, None]
             * (1 + 0.1 * rng.standard_normal((b, 480, 2)))).astype(np.float32)
        jstate, want = step(jstate, x)
        state, got = module(state, _t(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-2)
    _assert_states_close(state, jstate)


def test_adaptive_digital_components_match():
    """The speech-level estimator, saturation protector, noise floor and
    gain controller fed with scripted speech probabilities that cross the
    0.95 threshold and the 12-frame sequences."""
    b = 4
    cfg_j = JAdaptiveDigital(enabled=True)
    cfg = AdaptiveDigital(enabled=True)

    def jstep(sl, sat, nf, adp, lim_level, x, prob):
        nf, noise_dbfs = j_ad.noise_floor_analyze(nf, x, 48000)
        peak, rms = j_ad.compute_audio_levels(x)
        sl = j_ad.speech_level_update(sl, rms, prob)
        sat = j_ad.saturation_protector_analyze(sat, prob, peak, sl.level_dbfs)
        adp, y = j_ad.adaptive_digital_process(
            cfg_j, adp, x, prob, sl.level_dbfs, sl.is_confident, noise_dbfs,
            sat.headroom_db, j_ad.float_s16_to_dbfs(lim_level))
        return sl, sat, nf, adp, y

    def step(sl, sat, nf, adp, lim_level, x, prob):
        nf, noise_dbfs = ad.noise_floor_analyze(nf, x, 48000)
        peak, rms = ad.compute_audio_levels(x)
        sl = ad.speech_level_update(sl, rms, prob)
        sat = ad.saturation_protector_analyze(sat, prob, peak, sl.level_dbfs)
        adp, y = ad.adaptive_digital_process(
            cfg, adp, x, prob, sl.level_dbfs, sl.is_confident, noise_dbfs,
            sat.headroom_db, ad.float_s16_to_dbfs(lim_level))
        return sl, sat, nf, adp, y

    jfn = jax.jit(jax.vmap(jstep))
    js = (_batched(j_ad.init_speech_level(cfg_j), b),
          _batched(j_ad.init_saturation_protector(), b),
          _batched(j_ad.init_noise_floor(48000), b),
          _batched(j_ad.init_adaptive_digital(cfg_j), b))
    ts = (tree_to_state(ad.init_speech_level(cfg, 1, "cpu"), _np(js[0])),
          tree_to_state(ad.init_saturation_protector(1, "cpu"), _np(js[1])),
          tree_to_state(ad.init_noise_floor(48000, 1, "cpu"), _np(js[2])),
          tree_to_state(ad.init_adaptive_digital(cfg, 1, "cpu"),
                        _np(js[3])))
    rng = np.random.default_rng(8)
    lim_level = np.array([100.0, 3000.0, 30000.0, 40000.0], np.float32)
    frames = _speech(60, b, 48000, 6, channels=2)
    for f, x in enumerate(frames):
        x = x * np.array([0.05, 0.5, 1.0, 3.0], np.float32)[:, None, None]
        prob = np.where((np.arange(b) + f) % 17 < 14, 0.97,
                        rng.uniform(0, 0.9, b)).astype(np.float32)
        *js, jy = jfn(*js, lim_level, x, prob)
        *ts, y = step(*ts, _t(lim_level), _t(x), _t(prob))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-4,
                                   atol=1e-2)
    for s, j in zip(ts, js):
        _assert_states_close(s, j)


def test_gain_controller2_matches():
    b = 3
    cfg_j = JAgc2Config(enabled=True,
                        adaptive_digital=JAdaptiveDigital(enabled=True))
    cfg = Agc2Config(enabled=True, adaptive_digital=AdaptiveDigital(enabled=True))
    jstate = _batched(j_gc2.init_state(cfg_j, 48000, use_internal_vad=True,
                                       num_channels=2), b)
    state = tree_to_state(gc2.init_state(cfg, 48000, 1, "cpu"), _np(jstate))
    module = gc2.GainController2(cfg, 48000)
    step = jax.jit(jax.vmap(lambda s, x: j_gc2.process(cfg_j, s, x, 48000)))
    for f, x in enumerate(_speech(30, b, 48000, 12, channels=2)):
        jstate, jy, jinfo = step(jstate, x)
        state, y, info = module(state, _t(x))
        scale = float(np.abs(np.asarray(jy)).max())
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-4,
                                   atol=1e-4 * scale)
        for k, v in jinfo.items():
            np.testing.assert_allclose(info[k].numpy(), np.asarray(v),
                                       rtol=1e-4, atol=1e-4, err_msg=k)
        if f == 2:
            _assert_states_close(state, jstate)


@pytest.mark.parametrize("what", ["ivc"])
def test_gain_controller2_unported_parts_raise(what):
    from webrtc_audio_processing_tpu_torch.config import InputVolumeController
    cfg = Agc2Config(enabled=True,
                     input_volume_controller=InputVolumeController(True))
    with pytest.raises(NotImplementedError, match="item 12"):
        gc2.GainController2(cfg, 48000)
