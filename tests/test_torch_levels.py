"""The capture chain's level controls against the JAX package on the CPU:
the capture levels adjuster, the pre-amplifier, AGC2's input volume
controller (its mono controllers and clipping predictor) and
``gain_controller2.analyze`` + ``process`` with it. Inputs are made from
seeds with numpy; volumes must match exactly, float leaves within 1e-5 of
each leaf's scale."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webrtc_audio_processing_tpu import apm as j_apm
from webrtc_audio_processing_tpu import config as j_cfg
from webrtc_audio_processing_tpu.models import capture_levels_adjuster as j_cla
from webrtc_audio_processing_tpu.models.agc2 import gain_controller2 as j_gc2
from webrtc_audio_processing_tpu.models.agc2 import (
    input_volume_controller as j_ivc,
)

from webrtc_audio_processing_tpu_torch import apm
from webrtc_audio_processing_tpu_torch import config as cfg_mod
from webrtc_audio_processing_tpu_torch.apm import state_to_numpy
from webrtc_audio_processing_tpu_torch.models import (
    capture_levels_adjuster as cla,
)
from webrtc_audio_processing_tpu_torch.models.agc2 import gain_controller2 as gc2
from webrtc_audio_processing_tpu_torch.models.agc2 import (
    input_volume_controller as ivc,
)

from tests.torch_aec3_setup import flat

RTOL = 1e-5
N = 160


def assert_leaves(got: dict, want: dict, rtol=RTOL):
    """Integer and boolean leaves exactly, float leaves within ``rtol`` of
    each leaf's scale."""
    assert set(got) == set(want), set(got) ^ set(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, (k, g.shape, w.shape)
        if w.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            scale = max(float(np.abs(w).max()), 1e-6)
            np.testing.assert_allclose(g, w, rtol=0, atol=rtol * scale,
                                       err_msg=k)


# ------------------------------------------------- capture levels adjuster


def _frames(seed, n, batch=3, ch=2, amp=3000.0):
    rng = np.random.default_rng(seed)
    return (amp * rng.standard_normal((n, batch, N, ch))).astype(np.float32)


@pytest.mark.parametrize("emulated", [False, True])
def test_levels_adjuster_matches_jax_through_gain_changes(emulated):
    """Pre and post gains, the emulated level, and a change of all three
    that ramps within the next frame, per stream against the JAX step."""
    B = 3
    frames = _frames(1, 6, B)
    js = [j_cla.init_state(0.5, 2.0, 100, emulated) for _ in range(B)]
    st = cla.init_state(0.5, 2.0, 100, emulated, B, "cpu")
    pre = jax.jit(lambda s, x: j_cla.apply_pre_level_adjustment(s, x,
                                                                emulated))
    post = jax.jit(j_cla.apply_post_level_adjustment)
    for f in range(6):
        if f == 2:  # new gains and level: the next frame ramps to them
            js = [s.replace(pre_gain=jnp.float32(1.5),
                            post_gain=jnp.float32(0.25)) for s in js]
            js = [j_cla.set_analog_mic_gain_level(s, 200) for s in js]
            st = cla.set_analog_mic_gain_level(
                st.replace(pre_gain=torch.full((B,), 1.5),
                           post_gain=torch.full((B,), 0.25)), 200)
        want = []
        for b in range(B):
            js[b], y = pre(js[b], frames[f, b])
            js[b], z = post(js[b], y)
            want.append(np.asarray(z))
        st, y = cla.apply_pre_level_adjustment(st, torch.from_numpy(
            frames[f]), emulated)
        st, z = cla.apply_post_level_adjustment(st, y)
        np.testing.assert_allclose(z.numpy(), np.stack(want), rtol=RTOL,
                                   atol=1e-3)
        if f == 2:  # the ramp: the first sample and the last differ
            ratio = z.numpy()[0, :, 0] / frames[f, 0, :, 0]
            assert abs(ratio[0] - ratio[-1]) > 0.1
    assert_leaves(state_to_numpy(st),
                  {k: np.stack([flat(s)[k] for s in js])
                   for k in flat(js[0])})


def test_levels_adjuster_level_is_clamped():
    st = cla.init_state(1.0, 1.0, 100, True, 2, "cpu")
    assert st.emulated_level.tolist() == [100, 100]
    st = cla.set_analog_mic_gain_level(st, 999)
    assert st.emulated_level.tolist() == [cla.MAX_ANALOG_MIC_GAIN_LEVEL] * 2
    st = cla.set_analog_mic_gain_level(st, torch.tensor([-5, 37]))
    assert st.emulated_level.tolist() == [0, 37]


def _levels_config(m, pre_amp, levels):
    return m.Config().replace(
        pre_amplifier=m.PreAmplifier(enabled=True, fixed_gain_factor=pre_amp),
        capture_level_adjustment=m.CaptureLevelAdjustment(
            enabled=True, pre_gain_factor=levels[0],
            post_gain_factor=levels[1]),
    )


def test_pre_amplifier_and_levels_adjuster_in_the_apm_match_jax():
    """The pre-amplifier (clipped to +-32768) and the adjuster's two gains
    in the APM step, 16 kHz stereo, B = 2. At frame 3 the pre-amplifier's
    gain changes with the state kept (a runtime setting): it ramps within
    that frame."""
    B = 2
    rng = np.random.default_rng(3)
    frames = (0.6 * rng.standard_normal((6, B, N, 2))).astype(np.float32)
    gains = [2.0, 2.0, 2.0, 0.5, 0.5, 0.5]

    def geos(g):
        return (j_apm.ApmGeometry.create(_levels_config(j_cfg, g, (1.5, 0.8)),
                                         16000, 2),
                apm.ApmGeometry.create(_levels_config(cfg_mod, g, (1.5, 0.8)),
                                       16000, 2))

    jgeo, geo = geos(gains[0])
    js = jax.tree_util.tree_map(
        lambda a: np.broadcast_to(np.asarray(a), (B,) + np.shape(a)).copy(),
        j_apm.init_state(jgeo))
    state = apm.init_state(geo, B, device="cpu")
    steps = {}
    for f, g in enumerate(gains):
        jgeo, geo = geos(g)
        if g not in steps:
            steps[g] = jax.jit(jax.vmap(
                lambda s, c, jg=jgeo: j_apm.process_stream_pair(jg, s, c)))
        js, jy, _, _ = steps[g](js, frames[f])
        state, y, _, _ = apm.process_stream_pair(geo, state,
                                                 torch.from_numpy(frames[f]))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=RTOL,
                                   atol=1e-6)
        if f == 0:  # 0.6 x 2.0 x 1.5 clips before the 0.8 post gain
            assert float(np.abs(y.numpy()).max()) == pytest.approx(0.8)
    want = {k: v for k, v in flat(js).items()
            if k.startswith(("pre_amp_gain", "cla"))}
    got = {k: v for k, v in state_to_numpy(state).items()
           if k.startswith(("pre_amp_gain", "cla"))}
    assert_leaves(got, want)


# ---------------------------------------------- input volume controller


def test_gain_map_matches_jax_and_reference_table():
    np.testing.assert_array_equal(ivc.GAIN_MAP, j_ivc.GAIN_MAP)
    assert list(ivc.GAIN_MAP[:15]) == [-56, -54, -52, -50, -48, -47, -45,
                                       -43, -42, -40, -38, -37, -35, -34,
                                       -33]


def test_compute_volume_update_matches_jax_exactly():
    """Every gain error in [-20, 20] from every volume, floor 20."""
    err, vol = np.meshgrid(np.arange(-20, 21), np.arange(256), indexing="ij")
    want = jax.vmap(jax.vmap(
        lambda e, v: j_ivc.compute_volume_update(e, v, 20)))(
            jnp.asarray(err, jnp.int32), jnp.asarray(vol, jnp.int32))
    got = ivc.compute_volume_update(torch.from_numpy(err.astype(np.int32)),
                                    torch.from_numpy(vol.astype(np.int32)),
                                    20)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _ivc_inputs(seed, n_frames, B, C):
    """Per frame: applied volumes, audio (quiet, loud and clipping
    stretches), speech probabilities and levels."""
    rng = np.random.default_rng(seed)
    amp = np.where(np.arange(n_frames) % 9 < 4, 30000.0, 400.0)
    audio = (amp[:, None, None, None]
             * rng.standard_normal((n_frames, B, N, C))).astype(np.float32)
    audio = np.clip(audio, -32768.0, 32767.0)
    volumes = rng.integers(0, 256, (n_frames, B)).astype(np.int32)
    volumes[::3] = 0  # the unset-volume and zero-volume branches
    prob = rng.uniform(0.0, 1.0, (n_frames, B)).astype(np.float32)
    level = rng.uniform(-70.0, -10.0, (n_frames, B)).astype(np.float32)
    has = rng.uniform(size=(n_frames, B)) > 0.3
    return volumes, audio, prob, level, has


@pytest.mark.parametrize("cfg", [
    j_ivc.InputVolumeControllerConfig(clipped_wait_frames=3,
                                      update_input_volume_wait_frames=4,
                                      speech_ratio_threshold=0.3),
    j_ivc.InputVolumeControllerConfig(enable_clipping_predictor=False,
                                      clipped_wait_frames=2),
], ids=["predictor", "no_predictor"])
def test_input_volume_controller_matches_jax(cfg):
    """analyze_input_audio + recommend_input_volume for 3 streams of 2
    channels over 40 frames: clipping, predicted clipping, manual volume
    changes and speech-driven updates. Volumes and every leaf match."""
    B, C, n = 3, 2, 40
    pcfg = ivc.InputVolumeControllerConfig(**dataclasses.asdict(cfg))
    volumes, audio, prob, level, has = _ivc_inputs(11, n, B, C)

    @jax.jit
    @jax.vmap
    def jstep(s, vol, x, p, lv, h):
        s = j_ivc.analyze_input_audio(cfg, s, vol, x)
        return j_ivc.recommend_input_volume(cfg, s, p, lv, h)

    one = j_ivc.init_state(cfg, C)
    js = jax.tree_util.tree_map(
        lambda a: np.broadcast_to(np.asarray(a), (B,) + np.shape(a)).copy(),
        one)
    st = ivc.init_state(pcfg, C, B, "cpu")
    seen = set()
    for f in range(n):
        js, jrec, jvalid = jstep(js, volumes[f], audio[f], prob[f],
                                 level[f], has[f])
        st = ivc.analyze_input_audio(pcfg, st, torch.from_numpy(volumes[f]),
                                     torch.from_numpy(audio[f]))
        st, rec, valid = ivc.recommend_input_volume(
            pcfg, st, torch.from_numpy(prob[f]), torch.from_numpy(level[f]),
            torch.from_numpy(has[f]))
        np.testing.assert_array_equal(rec.numpy(), np.asarray(jrec))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
        assert_leaves(state_to_numpy(st), flat(js))
        seen.update(int(v) for v in np.asarray(jrec))
    assert len(seen) > 5  # the volume moved


def test_clipping_predictor_matches_jax_in_every_mode():
    """The level ring and EstimateClippedLevelStep in the event, adaptive
    and fixed-step peak modes."""
    B, C, n = 2, 2, 14
    rng = np.random.default_rng(5)
    amp = np.where(np.arange(n) < 8, 2000.0, 30000.0)
    audio = (amp[:, None, None, None] * rng.standard_normal(
        (n, B, N, C))).astype(np.float32)
    levels = np.array([200, 90], np.int32)
    for mode in (0, 1, 2):
        cfg = j_ivc.ClippingPredictorConfig(enabled=True, mode=mode,
                                            clipping_threshold=-6.0)
        pcfg = ivc.ClippingPredictorConfig(**dataclasses.asdict(cfg))
        js = jax.tree_util.tree_map(
            lambda a: np.broadcast_to(np.asarray(a),
                                      (B,) + np.shape(a)).copy(),
            j_ivc.init_clipping_predictor(C, cfg))
        st = ivc.init_clipping_predictor(C, pcfg, B, "cpu")
        for f in range(n):
            js = jax.vmap(lambda s, x: j_ivc.clipping_predictor_analyze(
                cfg, s, x))(js, audio[f])
            st = ivc.clipping_predictor_analyze(pcfg, st,
                                                torch.from_numpy(audio[f]))
            jhas, jstep = jax.vmap(lambda s, lv: j_ivc.clipping_predictor_step(
                cfg, s, lv, 15))(js, levels)
            has, step = ivc.clipping_predictor_step(
                pcfg, st, torch.from_numpy(levels), 15)
            np.testing.assert_array_equal(has.numpy(), np.asarray(jhas))
            np.testing.assert_array_equal(step.numpy(), np.asarray(jstep))
        assert_leaves(state_to_numpy(st), flat(js))


# The port alone: tests/test_input_volume_controller.py's behaviour.

def _run(cfg, frames, applied_volume, speech_level, speech_prob,
         audio_peak=1000.0):
    st = ivc.init_state(cfg, 1, 1, "cpu")
    audio = torch.full((1, N, 1), audio_peak)
    vol = applied_volume
    for _ in range(frames):
        st = ivc.analyze_input_audio(cfg, st, vol, audio)
        st, rec, _ = ivc.recommend_input_volume(
            cfg, st, torch.tensor([speech_prob]), torch.tensor([speech_level]),
            torch.tensor([True]))
        vol = int(rec[0])
    return vol


@pytest.mark.parametrize("applied,level,prob,check", [
    (100, -60.0, 0.9, lambda v: v > 100),  # too quiet: up
    (200, -10.0, 0.9, lambda v: v < 200),  # too loud: down
    (100, -60.0, 0.0, lambda v: v == 100),  # no speech: no update
], ids=["raises_quiet", "lowers_loud", "holds_without_speech"])
def test_input_volume_controller_behaviour(applied, level, prob, check):
    cfg = ivc.InputVolumeControllerConfig(enable_clipping_predictor=False)
    vol = _run(cfg, 250, applied, level, prob)
    assert check(vol), vol


def test_input_volume_controller_clipping_drops_volume():
    cfg = ivc.InputVolumeControllerConfig(enable_clipping_predictor=False)
    st = ivc.init_state(cfg, 1, 1, "cpu")

    def step(st, vol, peak):
        st = ivc.analyze_input_audio(cfg, st, vol, torch.full((1, N, 1),
                                                              peak))
        return ivc.recommend_input_volume(cfg, st, torch.tensor([0.0]),
                                          torch.tensor([-40.0]),
                                          torch.tensor([True]))[:2]

    st, rec = step(st, 200, 1000.0)
    assert int(rec) == 200
    st, rec = step(st, int(rec), 32767.5)
    assert int(rec) == 200 - cfg.clipped_level_step
    st, rec2 = step(st, int(rec), 32767.5)  # within the wait: no drop
    assert int(rec2) == int(rec)
    assert _run(cfg, 10, 5, -40.0, 0.9) >= cfg.min_input_volume


# ------------------------------------------------- gain controller 2


def _speech(n, fs, amp, seed):
    """Voiced-speech-like: a pitch-vibrato sawtooth with a slow envelope
    (tests/test_ivc_apm.py) plus a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    f0 = 120 * (1 + 0.06 * np.sin(2 * np.pi * 3.1 * t))
    phase = 2 * np.pi * np.cumsum(f0) / fs
    saw = sum((1.0 / k) * np.sin(k * phase) for k in range(1, 12))
    x = saw * (0.6 + 0.4 * np.sin(2 * np.pi * 1.7 * t))
    x = amp * x / np.abs(x).max() + 1e-4 * rng.standard_normal(n)
    return (32768.0 * x).astype(np.float32)


@pytest.mark.parametrize("amp", [0.003, 0.5], ids=["quiet", "loud"])
def test_gain_controller2_with_the_input_volume_controller_matches_jax(amp):
    """``analyze`` then ``process`` over 12 frames of speech, 2 streams at
    16 kHz, the applied volume fed back from the recommendation: volumes
    exact, the output and every state leaf within tolerance."""
    B, fs, n = 2, 16000, 12
    jconf = j_cfg.GainController2(
        enabled=True, adaptive_digital=j_cfg.AdaptiveDigital(enabled=True),
        input_volume_controller=j_cfg.InputVolumeController(enabled=True))
    conf = cfg_mod.GainController2(
        enabled=True, adaptive_digital=cfg_mod.AdaptiveDigital(enabled=True),
        input_volume_controller=cfg_mod.InputVolumeController(enabled=True))
    x = np.stack([_speech(n * N, fs, amp, s) for s in range(B)])
    x = x.reshape(B, n, N, 1).transpose(1, 0, 2, 3).copy()

    @jax.jit
    @jax.vmap
    def jstep(s, vol, frame):
        s = j_gc2.analyze(jconf, s, vol, frame)
        return j_gc2.process(jconf, s, frame, fs)

    js = jax.tree_util.tree_map(
        lambda a: np.broadcast_to(np.asarray(a), (B,) + np.shape(a)).copy(),
        j_gc2.init_state(jconf, fs, use_internal_vad=True))
    st = gc2.init_state(conf, fs, B, "cpu")
    module = gc2.GainController2(conf, fs)
    vol = np.array([80, 200], np.int32)
    for f in range(n):
        js, jy, jinfo = jstep(js, vol, x[f])
        st = gc2.analyze(st, torch.from_numpy(vol), torch.from_numpy(x[f]))
        st, y, info = module(st, torch.from_numpy(x[f]))
        np.testing.assert_array_equal(
            info["recommended_input_volume"].numpy(),
            np.asarray(jinfo["recommended_input_volume"]))
        np.testing.assert_array_equal(
            info["recommended_input_volume_valid"].numpy(),
            np.asarray(jinfo["recommended_input_volume_valid"]))
        scale = max(float(np.abs(np.asarray(jy)).max()), 1.0)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0,
                                   atol=1e-4 * scale)
        vol = info["recommended_input_volume"].numpy()
    assert_leaves({k: v for k, v in state_to_numpy(st).items()
                   if k.startswith("ivc")},
                  {k: v for k, v in flat(js).items() if k.startswith("ivc")})
    assert {k for k in info} == {k for k in jinfo}
