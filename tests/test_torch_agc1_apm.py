"""AGC1 through the APM against the JAX package on the CPU: 16 kHz mono
with HPF, NS and AGC1, in the hybrid mode (``GainController1(enabled=True)``:
adaptive analog through AgcManagerDirect) and in adaptive digital mode,
B = 2 streams for 60 frames with each package's analog level fed back as
the next frame's applied volume (the reference's ApmTest loop). The JAX
package's ``apm.process_stream_pair`` compiles at static parities 0 and 2
for the hybrid mode (with no AEC3 only the analytics VAD's phase 2 of
``parity % 3`` changes the step) and once for adaptive digital mode,
where no module reads the parity. Also the API's level loop and its
``CAPTURE_COMPRESSION_GAIN`` setting, and the graph's pair body at period
6 against plain steps."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webrtc_audio_processing_tpu import apm as j_apm
from webrtc_audio_processing_tpu import config as j_cfg

from webrtc_audio_processing_tpu_torch import api, apm, step_graph
from webrtc_audio_processing_tpu_torch import config as cfg_mod
from webrtc_audio_processing_tpu_torch.models.agc1 import (
    digital,
    gain_control,
)

from tests.torch_agc1_util import assert_states, batched, compile_all, t

B = 2
N_FRAMES = 60
RATE = 16000
FRAME = RATE // 100
MODES = ("hybrid", "adaptive_digital")


def config(m, mode):
    if mode == "hybrid":
        gc1 = m.GainController1(enabled=True)
    else:
        gc1 = m.GainController1(
            enabled=True, mode=m.Agc1Mode.ADAPTIVE_DIGITAL,
            analog_gain_controller=m.AnalogGainController(enabled=False))
    return m.Config().replace(
        high_pass_filter=m.HighPassFilter(enabled=True),
        noise_suppression=m.NoiseSuppression(enabled=True),
        gain_controller1=gc1)


def voiced(n, amp, f0, rate=RATE):
    """tests/test_agc_manager_apm.py's ``_voiced``."""
    tt = np.arange(n) / rate
    ph = 2 * np.pi * np.cumsum(f0 * (1 + 0.05 * np.sin(2 * np.pi * 3 * tt)))
    ph = ph / rate
    w = {1: 0.3, 2: 0.6, 3: 1.0, 4: 1.0, 5: 0.7}
    saw = sum(w.get(k, 1.0 / k) * np.sin(k * ph) for k in range(1, 10))
    x = saw * (0.7 + 0.3 * np.sin(2 * np.pi * 1.5 * tt))
    return amp * x / np.abs(x).max()


def scene():
    """Stream 0: quiet speech in noise; stream 1: louder speech with a
    stretch driven far into clipping at frames 10-12. (B, n, 1) float32."""
    rng = np.random.default_rng(31)
    n = N_FRAMES * FRAME
    x = np.stack([voiced(n, 0.02, 120) + 0.002 * rng.standard_normal(n),
                  voiced(n, 0.3, 200)])
    x[1, 10 * FRAME:13 * FRAME] *= 100.0
    return np.clip(x, -1.0, 1.0)[..., None].astype(np.float32)


@pytest.fixture(scope="module")
def runs():
    """Both packages on the scene in both modes, the level loop closed on
    each side: JAX's AudioProcessing writes the level into AGC1's state
    and passes it as the applied volume (api.py:686-695), as the port's
    does."""
    from webrtc_audio_processing_tpu.models.agc1 import gain_control as j_gc

    x = scene()
    jobs, jgeos = {}, {}
    for mode in MODES:
        jgeo = jgeos[mode] = j_apm.ApmGeometry.create(config(j_cfg, mode),
                                                      RATE, 1)
        js = batched(j_apm.init_state(jgeo), B)
        # Without AEC3 only the hybrid manager reads the parity, as
        # ``parity % 3 == 2`` (its analytics VAD's phase 2).
        for ph in ((0, 2) if jgeo.agc1_hybrid else (0,)):
            def fn(s, c, v, g=jgeo, ph=ph):
                s = s.replace(agc1=j_gc.set_stream_analog_level(s.agc1, v))
                return j_apm.process_stream_pair(g, s, c, None, ph,
                                                 applied_input_volume=v)
            jobs[(mode, ph)] = (jax.vmap(fn), (js, x[:, :FRAME],
                                               jnp.zeros(B, jnp.int32)))
    steps = compile_all(jobs)
    out = {"scene": x}
    for mode in MODES:
        geo = apm.ApmGeometry.create(config(cfg_mod, mode), RATE, 1)
        js = batched(j_apm.init_state(jgeos[mode]), B)
        state = apm.state_from_jax(jax.tree_util.tree_map(np.asarray, js),
                                   geo)
        jl = pl = np.full(B, 100, np.int32)
        r = {"jax": [], "torch": [], "jax_level": [], "torch_level": []}
        for f in range(N_FRAMES):
            fr = x[:, f * FRAME:(f + 1) * FRAME]
            step = steps.get((mode, 2), steps[(mode, 0)]) if f % 3 == 2 \
                else steps[(mode, 0)]
            js, jy, _, jst = step(js, fr, jnp.asarray(jl))
            state = dataclasses.replace(
                state, agc1=gain_control.set_stream_analog_level(
                    state.agc1, t(pl)))
            state, y, _, st = apm.process_stream_pair(
                geo, state, t(fr), applied_input_volume=t(pl))
            jl = np.asarray(jst["agc1_recommended_level"])
            pl = st["agc1_recommended_level"].numpy()
            r["jax"].append(np.asarray(jy))
            r["torch"].append(y.numpy())
            r["jax_level"].append(jl)
            r["torch_level"].append(pl)
        r["jax_state"] = jax.tree_util.tree_map(np.asarray, js)
        r["torch_state"] = state
        r["jax_stats"] = jax.tree_util.tree_map(np.asarray, jst)
        r["torch_stats"] = {k: v.numpy() for k, v in st.items()}
        out[mode] = r
    return out


@pytest.mark.parametrize("mode", MODES)
def test_analog_level_within_one_every_frame(runs, mode):
    """The ApmTest bar: each package's recommended level, its own fed back,
    within +-1 of the other's on every frame; the clipping moved stream
    1's level in the hybrid mode."""
    got = np.stack(runs[mode]["torch_level"]).astype(int)
    want = np.stack(runs[mode]["jax_level"]).astype(int)
    assert np.abs(got - want).max() <= 1, (got.T, want.T)
    if mode == "hybrid":
        assert want[-1, 1] < 100, want[:, 1]


@pytest.mark.parametrize("mode", MODES)
def test_output_relative_rms(runs, mode):
    """Relative RMS <= 1e-3 per stream over the 60 frames."""
    got = np.stack(runs[mode]["torch"])
    want = np.stack(runs[mode]["jax"])
    err = np.sqrt(((got - want) ** 2).sum(axis=(0, 2, 3))
                  / (want ** 2).sum(axis=(0, 2, 3)))
    assert (err <= 1e-3).all(), err
    assert np.isfinite(got).all()


@pytest.mark.parametrize("mode", MODES)
def test_agc1_state_after_60_frames(runs, mode):
    """AGC1's and the manager's leaves after the last frame: integer and
    bool leaves exact, float leaves within 1e-3 of each leaf's scale (the
    analytics VAD's own state is held in tests/test_torch_vad.py)."""
    got, want = runs[mode]["torch_state"], runs[mode]["jax_state"]
    assert_states(got.agc1, want.agc1, rtol=1e-3)
    if mode == "hybrid":
        assert_states(got.agc_mgr, want.agc_mgr, rtol=1e-3,
                      skip=("monos.agc.vad",))
    else:
        assert got.agc_mgr is None and want.agc_mgr is None


@pytest.mark.parametrize("mode", MODES)
def test_stats_match_jax(runs, mode):
    want, got = runs[mode]["jax_stats"], runs[mode]["torch_stats"]
    assert set(got) == set(want)
    for k, w in want.items():
        if w.dtype.kind in "iub":
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], w, atol=1e-3, err_msg=k)


def test_api_level_loop_matches_jax(runs):
    """api.AudioProcessing in the hybrid mode on stream 1 (the clipped
    one), its recommendation fed back through set_stream_analog_level:
    levels within +-1 of the JAX run's on every frame, the output within
    1e-3 relative RMS."""
    ap = api.AudioProcessing(config(cfg_mod, "hybrid"), device="cpu")
    x = runs["scene"][1]
    level, levels, outs = 100, [], []
    for f in range(N_FRAMES):
        ap.set_stream_analog_level(level)
        err, out = ap.process_stream(x[f * FRAME:(f + 1) * FRAME], RATE)
        assert err == api.kNoError
        level = ap.recommended_stream_analog_level()
        levels.append(level)
        outs.append(out)
    want = np.stack(runs["hybrid"]["jax_level"])[:, 1].astype(int)
    assert np.abs(np.array(levels) - want).max() <= 1, (levels, want)
    got = np.concatenate(outs)[:, 0]
    ref = np.concatenate([y[1, :, 0] for y in runs["hybrid"]["jax"]])
    assert np.sqrt(((got - ref) ** 2).sum() / (ref ** 2).sum()) <= 1e-3
    assert ap._state.agc1.analog_level.tolist() == [levels[-2]]


def test_api_compression_gain_setting():
    """CAPTURE_COMPRESSION_GAIN: in adaptive digital mode it changes AGC1's
    compression (rounded), rebuilds the gain table and keeps the stream's
    state; with the hybrid manager it is ignored."""
    ap = api.AudioProcessing(config(cfg_mod, "adaptive_digital"),
                             device="cpu")
    x = scene()[1, :5 * FRAME]
    for f in range(3):
        ap.process_stream(x[f * FRAME:(f + 1) * FRAME], RATE)
    before = ap._state
    assert ap.set_runtime_setting(
        api.RuntimeSetting.create_compression_gain_db(15))
    assert ap._config.gain_controller1.compression_gain_db == 15
    assert ap._state is before and ap._state.frame_counter == 3
    want = digital.calculate_gain_table(15, 3, True, 11)
    np.testing.assert_array_equal(ap._module.agc1.gain_table.numpy(), want)
    err, _ = ap.process_stream(x[3 * FRAME:4 * FRAME], RATE)
    assert err == api.kNoError

    hybrid = api.AudioProcessing(config(cfg_mod, "hybrid"), device="cpu")
    hybrid.set_runtime_setting(
        api.RuntimeSetting.create_compression_gain_db(15))
    assert hybrid._config.gain_controller1.compression_gain_db == 9


def test_agc1_geometry_accepts_all_modes_and_names_the_period():
    """ApmGeometry.create takes AGC1 in its three modes; the cadence's
    period is 6 with the hybrid manager, 2 without it."""
    for mode, hybrid in ((cfg_mod.Agc1Mode.ADAPTIVE_ANALOG, True),
                         (cfg_mod.Agc1Mode.ADAPTIVE_DIGITAL, True),
                         (cfg_mod.Agc1Mode.FIXED_DIGITAL, True)):
        c = cfg_mod.Config().replace(
            gain_controller1=cfg_mod.GainController1(enabled=True, mode=mode))
        geo = apm.ApmGeometry.create(c, 48000, 2)
        assert geo.agc1_hybrid == hybrid and apm.parity_period(geo) == 6
        c = c.replace(gain_controller1=cfg_mod.GainController1(
            enabled=True, mode=mode,
            analog_gain_controller=cfg_mod.AnalogGainController(
                enabled=False)))
        geo = apm.ApmGeometry.create(c, 48000, 2)
        assert not geo.agc1_hybrid and apm.parity_period(geo) == 2


def test_pair_body_at_period_6_equals_plain_steps_on_every_leaf():
    """Three pairs of ``step_graph.step_pair``, the volume taking frame
    1's recommendation on the device between pairs, at 16 kHz mono with
    HPF, AEC3, NS and the hybrid AGC1 (the cadence of AEC3's % 2 and the
    analytics VAD's % 3), against six plain ``process_stream_pair`` calls
    fed the same levels from an equal state: every output, stat and state
    leaf bit for bit."""
    c = config(cfg_mod, "hybrid").replace(
        echo_canceller=cfg_mod.EchoCanceller(enabled=True))
    geo = apm.ApmGeometry.create(c, RATE, 1)
    assert apm.parity_period(geo) == 6
    rng = np.random.default_rng(7)
    far = (0.1 * rng.standard_normal((6, B, FRAME, 1))).astype(np.float32)
    near = (0.4 * far + scene()[None, :, :FRAME] * 0.5).astype(np.float32)
    owned = apm.init_state(geo, B, device="cpu")
    plain = apm.init_state(geo, B, device="cpu")
    volume = torch.full((B,), 100, dtype=torch.int32)
    level = volume.clone()
    for p in range(3):
        frames = [(t(far[f]), t(near[f])) for f in (2 * p, 2 * p + 1)]
        outs = step_graph.step_pair(geo, owned, *frames[0], *frames[1],
                                    volume=volume)
        volume.copy_(outs[1][2]["agc1_recommended_level"])
        for (out, rout, stats), (r, cap) in zip(outs, frames):
            plain, p_out, p_rout, p_stats = apm.process_stream_pair(
                geo, plain, cap, r, applied_input_volume=level)
            assert torch.equal(out, p_out) and torch.equal(rout, p_rout)
            for k, v in p_stats.items():
                assert torch.equal(stats[k], v), k
        level = p_stats["agc1_recommended_level"]
        assert torch.equal(volume, level)
    assert owned.frame_counter == plain.frame_counter == 6
    got, want = apm.state_to_numpy(owned), apm.state_to_numpy(plain)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.mark.slow
def test_48k_stereo_with_aec3_matches_jax():
    """The hybrid AGC1 in the 48 kHz stereo pipeline with AEC3 (processed
    mono at 32 kHz in two bands), B = 2 for 24 frames from JAX's state:
    recommended levels equal, output within 1e-3 relative RMS."""
    import chip_smoke

    x = scene()
    render, capture = chip_smoke.echo_scene(24, 5, range(B))
    capture = capture + np.repeat(
        np.stack([np.interp(np.arange(24 * 480) / 3.0, np.arange(960),
                            x[b, :960, 0]) for b in range(B)])[..., None],
        2, axis=2).astype(np.float32)

    def cfg(m):
        return config(m, "hybrid").replace(
            echo_canceller=m.EchoCanceller(enabled=True))

    jgeo = j_apm.ApmGeometry.create(cfg(j_cfg), 48000, 2,
                                    num_render_channels=2)
    geo = apm.ApmGeometry.create(cfg(cfg_mod), 48000, 2,
                                 num_render_channels=2)
    js = batched(j_apm.init_state(jgeo), B)
    steps = compile_all({ph: (jax.vmap(
        lambda s, c, r, v, n0, ph=ph: j_apm.process_stream_pair(
            jgeo, s, c, r, ph, applied_input_volume=v, n0=n0),
        in_axes=(0, 0, 0, 0, None)), (js, capture[:, :480], render[:, :480],
                                      jnp.zeros(B, jnp.int32), jnp.int32(0)))
        for ph in range(6)})
    state = apm.state_from_jax(jax.tree_util.tree_map(np.asarray, js), geo)
    lv = np.full(B, 100, np.int32)
    got, want = [], []
    for f in range(24):
        sl = slice(f * 480, (f + 1) * 480)
        n0 = apm.block_ordinal(f)
        js, jy, _, jst = steps[f % 6](js, capture[:, sl], render[:, sl],
                                      jnp.asarray(lv), jnp.int32(n0))
        state, y, _, st = apm.process_stream_pair(
            geo, state, t(capture[:, sl]), t(render[:, sl]),
            applied_input_volume=t(lv))
        np.testing.assert_array_equal(
            st["agc1_recommended_level"].numpy(),
            np.asarray(jst["agc1_recommended_level"]))
        lv = np.asarray(jst["agc1_recommended_level"])
        got.append(y.numpy())
        want.append(np.asarray(jy))
    got, want = np.stack(got), np.stack(want)
    err = np.sqrt(((got - want) ** 2).sum(axis=(0, 2, 3))
                  / (want ** 2).sum(axis=(0, 2, 3)))
    assert (err <= 1e-3).all(), err
