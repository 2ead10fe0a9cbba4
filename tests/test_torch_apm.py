"""The port's capture slice end to end against the JAX package on the CPU:
48 kHz stereo, full-band HPF + NS + AGC2 with the RNN-VAD, no echo
canceller, through ``apm.process_stream_pair``."""

import dataclasses
import enum
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webrtc_audio_processing_tpu import apm as j_apm
from webrtc_audio_processing_tpu import config as j_cfg

from webrtc_audio_processing_tpu_torch import apm
from webrtc_audio_processing_tpu_torch import config as cfg_mod
from webrtc_audio_processing_tpu_torch.ops import cuda_biquad, cuda_window

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 3


def _slice_config(m):
    return m.Config().replace(
        pipeline=m.Pipeline(multi_channel_capture=True,
                            multi_channel_render=True,
                            maximum_internal_processing_rate=48000),
        high_pass_filter=m.HighPassFilter(enabled=True),
        noise_suppression=m.NoiseSuppression(enabled=True),
        gain_controller2=m.GainController2(
            enabled=True, adaptive_digital=m.AdaptiveDigital(enabled=True)),
    )


def _geometries():
    kw = dict(render_input_rate=48000, num_render_channels=2)
    return (j_apm.ApmGeometry.create(_slice_config(j_cfg), 48000, 2, **kw),
            apm.ApmGeometry.create(_slice_config(cfg_mod), 48000, 2, **kw))


def _frames(n_frames, seed):
    """Per-stream harmonic tones with amplitude modulation plus noise, in
    [-1, 1]: (n_frames, B, 480, 2)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_frames * 480)[None, :] / 48000.0
    f0 = rng.uniform(90, 250, (B, 1))
    am = 0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(2, 5, (B, 1)) * t)
    sig = sum(np.sin(2 * np.pi * f0 * k * t) / k for k in range(1, 8)) * am
    x = rng.uniform(0.05, 0.2, (B, 1, 1)) * sig[:, :, None] \
        + 0.01 * rng.standard_normal((B, n_frames * 480, 2))
    return x.astype(np.float32).reshape(B, n_frames, 480, 2).transpose(
        1, 0, 2, 3)


def _flat(tree):
    return {jax.tree_util.keystr(p)[1:]: np.asarray(leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_init(jgeo):
    return jax.tree_util.tree_map(lambda a: jnp.broadcast_to(a, (B,) + a.shape),
                                  j_apm.init_state(jgeo))


def _config_tree(cfg):
    """{dotted field path: default}, enums by value."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            out.update({f"{f.name}.{k}": w for k, w in _config_tree(v).items()})
        else:
            out[f.name] = v.value if isinstance(v, enum.Enum) else v
    return out


def test_config_has_the_jax_fields_and_defaults():
    want = _config_tree(j_cfg.Config())
    got = _config_tree(cfg_mod.Config())
    assert got == want
    for name in ("DownmixMethod", "NoiseSuppressionLevel", "Agc1Mode",
                 "ClippingPredictorMode"):
        assert ([m.value for m in getattr(cfg_mod, name)]
                == [m.value for m in getattr(j_cfg, name)]), name


def test_state_bridge_round_trips_leaf_by_leaf():
    jgeo, geo = _geometries()
    jstate = _flat(_jax_init(jgeo))
    state = apm.state_from_jax(
        jax.tree_util.tree_map(np.asarray, _jax_init(jgeo)), geo)
    back = apm.state_to_numpy(state)
    assert set(back) == set(jstate)
    for k, v in jstate.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    # The port's own init_state is the same state.
    own = apm.state_to_numpy(apm.init_state(geo, B, device="cpu"))
    for k, v in jstate.items():
        np.testing.assert_array_equal(own[k], v, err_msg=k)


def _rel_rms(got, want):
    return np.sqrt(((got - want) ** 2).sum(axis=(1, 2))
                   / (want ** 2).sum(axis=(1, 2)))


def test_slice_matches_jax_end_to_end():
    """B = 3 streams, 30 frames after an onset frame. State after 3 frames:
    float leaves within rtol 1e-4 of each leaf's scale, integer and boolean
    leaves exact. Output: relative RMS <= 1e-3 per stream (the BASELINE.md
    bar), speech probability within 1e-3. On the CPU neither kernel
    launches.

    On a stream's first frame the RNN-VAD searches pitch in a buffer that
    is mostly zeros, where near-ties make the period depend on float noise
    (ROADMAP Queue 3). The onset frame's output is compared, then both
    sides continue from the JAX state after it."""
    jgeo, geo = _geometries()
    step = jax.jit(jax.vmap(
        lambda s, c, r: j_apm.process_stream_pair(jgeo, s, c, r)))
    k1, k5 = cuda_biquad.launches, cuda_window.launches
    captures, renders = _frames(31, 1), _frames(31, 2)

    jstate = _jax_init(jgeo)
    state = apm.state_from_jax(jax.tree_util.tree_map(np.asarray, jstate), geo)
    jstate, jout, _, _ = step(jstate, captures[0], renders[0])
    _, out, _, _ = apm.process_stream_pair(
        geo, state, torch.from_numpy(captures[0]),
        torch.from_numpy(renders[0]))
    rel0 = _rel_rms(out.numpy(), np.asarray(jout))
    assert (rel0 <= 1e-3).all(), rel0

    state = apm.state_from_jax(jax.tree_util.tree_map(np.asarray, jstate), geo)
    err = np.zeros(B)
    ref = np.zeros(B)
    dprob = 0.0
    for f in range(1, 31):
        jstate, jout, jrout, jstats = step(jstate, captures[f], renders[f])
        state, out, rout, stats = apm.process_stream_pair(
            geo, state, torch.from_numpy(captures[f]),
            torch.from_numpy(renders[f]))
        jout = np.asarray(jout)
        err += ((out.numpy() - jout) ** 2).sum(axis=(1, 2))
        ref += (jout ** 2).sum(axis=(1, 2))
        np.testing.assert_allclose(rout.numpy(), np.asarray(jrout), rtol=1e-4,
                                   atol=3e-6)
        dprob = max(dprob, float(np.abs(
            stats["agc2_speech_probability"].numpy()
            - np.asarray(jstats["agc2_speech_probability"])).max()))
        if f == 3:
            want = _flat(jstate)
            got = apm.state_to_numpy(state)
            assert set(got) == set(want)
            for k, w in want.items():
                if w.dtype.kind in "iub":
                    np.testing.assert_array_equal(got[k], w, err_msg=k)
                else:
                    scale = max(float(np.abs(w).max()), 1e-6)
                    np.testing.assert_allclose(got[k], w, rtol=1e-4,
                                               atol=1e-4 * scale, err_msg=k)
    rel = np.sqrt(err / ref)
    assert (rel <= 1e-3).all(), rel
    assert dprob <= 1e-3, dprob
    assert (cuda_biquad.launches, cuda_window.launches) == (k1, k5)


def test_render_only_and_capture_only_steps():
    _, geo = _geometries()
    state = apm.init_state(geo, 2, device="cpu")
    x = torch.from_numpy(_frames(1, 3)[0][:2])
    state, rout, bands = apm.process_render_stream(geo, state, x)
    assert rout.shape == (2, 480, 2) and bands.shape == (2, 3, 160, 2)
    state, out, none, stats = apm.process_stream_pair(geo, state, x)
    assert none is None and out.shape == (2, 480, 2)
    assert torch.isfinite(out).all()
    assert set(stats) == {"agc2_speech_probability", "agc2_noise_rms_dbfs",
                          "agc2_speech_level_dbfs",
                          "agc2_speech_level_is_confident", "agc2_headroom_db"}


_MOBILE = dict(echo_canceller=cfg_mod.EchoCanceller(enabled=True,
                                                   mobile_mode=True))
_MOBILE_AGC1 = dict(_MOBILE,
                    gain_controller1=cfg_mod.GainController1(enabled=True))


@pytest.mark.parametrize("case", ["api_agc1", "api_aecm", "api_agc1_apply",
                                  "apm_aecm", "apm_agc1"])
def test_mobile_configs_build_and_run(case):
    """The configs that raised until AECM was ported: the API built with
    (or switched by apply_config to) the mobile echo canceller, alone or
    beside AGC1, and the APM's geometry with them at 48 kHz stereo; each
    runs one frame on the CPU with finite output."""
    from webrtc_audio_processing_tpu_torch import api

    x = np.random.default_rng(1).uniform(-0.3, 0.3, (480, 2)).astype(
        np.float32)
    if case.startswith("api"):
        extra = _MOBILE if case == "api_aecm" else _MOBILE_AGC1
        config = cfg_mod.Config().replace(**extra)
        if case == "api_agc1_apply":
            ap = api.AudioProcessing(device="cpu")
            ap.apply_config(config)
        else:
            ap = api.AudioProcessing(config, device="cpu")
        assert ap.process_reverse_stream(x, 48000)[0] == api.kNoError
        err, out = ap.process_stream(x, 48000)
        assert err == api.kNoError and ap._geo.aecm is not None
    else:
        extra = _MOBILE if case == "apm_aecm" else _MOBILE_AGC1
        geo = apm.ApmGeometry.create(_slice_config(cfg_mod).replace(**extra),
                                     48000, 2, num_render_channels=2)
        assert geo.aecm.sample_rate_hz == 16000 and geo.aec3 is None
        state = apm.init_state(geo, 1, device="cpu")
        _, out, _, _ = apm.process_stream_pair(
            geo, state, torch.from_numpy(x[None]), torch.from_numpy(x[None]),
            stream_delay_ms=20)
        out = out[0].numpy()
    assert out.shape == (480, 2) and np.isfinite(out).all()


@pytest.mark.parametrize("rates", [(32000, 32000), (48000, 16000)])
def test_qmf_split_and_resampling_rates_run(rates):
    """The 32 kHz QMF split and API/processing resampling (48 kHz in,
    processed and sent out at 16 kHz) build and run a frame."""
    config = _slice_config(cfg_mod)
    geo = apm.ApmGeometry.create(config, rates[0], 2,
                                 capture_output_rate=rates[1])
    state = apm.init_state(geo, 1, device="cpu")
    x = torch.from_numpy(_frames(1, 4)[0][:1, :rates[0] // 100].copy())
    state, out, _, _ = apm.process_stream_pair(geo, state, x)
    assert out.shape == (1, rates[1] // 100, 2)
    assert torch.isfinite(out).all()


def test_injections_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        apm.ApmGeometry.create(_slice_config(cfg_mod), 48000, 2,
                               injections=object())


def test_port_imports_and_runs_without_jax():
    """With jax unimportable, the port imports and runs one frame on the
    CPU (the desktop pipeline, then the mobile one with AECM), imports the
    AECM, int FFT and legacy resampler modules, and never imports the JAX
    package."""
    code = r"""
import sys
sys.modules["jax"] = None
import numpy as np, torch
from webrtc_audio_processing_tpu_torch import apm, config as c
cfg = c.Config().replace(
    pipeline=c.Pipeline(multi_channel_capture=True, multi_channel_render=True,
                        maximum_internal_processing_rate=48000),
    high_pass_filter=c.HighPassFilter(enabled=True),
    noise_suppression=c.NoiseSuppression(enabled=True),
    gain_controller2=c.GainController2(
        enabled=True, adaptive_digital=c.AdaptiveDigital(enabled=True)))
geo = apm.ApmGeometry.create(cfg, 48000, 2, num_render_channels=2)
state = apm.init_state(geo, 1, device="cpu")
x = torch.from_numpy(np.random.default_rng(0).uniform(
    -0.3, 0.3, (1, 480, 2)).astype(np.float32))
state, out, rout, stats = apm.process_stream_pair(geo, state, x, x)
assert out.shape == (1, 480, 2) and bool(torch.isfinite(out).all())
from webrtc_audio_processing_tpu_torch import api, run_offline, runtime
ap = api.AudioProcessing(cfg, device="cpu")
err, y = ap.process_stream(x[0].numpy(), 48000)
assert err == 0 and y.shape == (480, 2)
assert runtime.BatchEngine and runtime.apm_step_fn and run_offline.main
mobile = cfg.replace(echo_canceller=c.EchoCanceller(enabled=True,
                                                    mobile_mode=True))
geo = apm.ApmGeometry.create(mobile, 48000, 2, num_render_channels=2)
state = apm.init_state(geo, 1, device="cpu")
state, out, rout, stats = apm.process_stream_pair(geo, state, x, x,
                                                  stream_delay_ms=30)
assert geo.aecm is not None and bool(torch.isfinite(out).all())
from webrtc_audio_processing_tpu_torch.models.aecm import core
from webrtc_audio_processing_tpu_torch.ops import int_fft, legacy_resampler
rc, y16 = legacy_resampler.Resampler(48000, 16000, 1).push(
    np.zeros(480, np.int16))
assert rc == 0 and y16.shape == (160,)
assert core.process_block and int_fft.real_forward_fft_i16
bad = [m for m in sys.modules
       if m == "jax" or m.startswith(("jax.", "jaxlib",
                                      "webrtc_audio_processing_tpu."))
       or m == "webrtc_audio_processing_tpu"]
assert not [m for m in bad if sys.modules[m] is not None], bad
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def _aec3_config(**kw):
    return _slice_config(cfg_mod).replace(
        echo_canceller=cfg_mod.EchoCanceller(enabled=True), **kw)


def _aec3_cfg_with(**delay):
    from webrtc_audio_processing_tpu_torch.models.aec3 import (
        config as a3cfg,
    )

    c = a3cfg.EchoCanceller3Config()
    return c.replace(delay=dataclasses.replace(c.delay, **delay))


_UNPORTED_AEC3 = {
    "pair_phase_false": lambda: _aec3_geo_pair_phase_false(),
    "debug_taps": lambda: apm.ApmGeometry.create(
        _aec3_config(), 48000, 2, num_render_channels=2, debug_taps=True),
    "nree": lambda: _aec3_geo_nree(),
    "bf16_rings": lambda: apm.ApmGeometry.create(
        _aec3_config(), 48000, 2, num_render_channels=2,
        aec3_ring_dtype="bfloat16"),
    "fixed_capture_delay": lambda: apm.ApmGeometry.create(
        _aec3_config(), 48000, 2, num_render_channels=2,
        aec3_cfg=_aec3_cfg_with(fixed_capture_delay_samples=32)),
    "down_sampling_by_8": lambda: apm.ApmGeometry.create(
        _aec3_config(), 48000, 2, num_render_channels=2,
        aec3_cfg=_aec3_cfg_with(down_sampling_factor=8)),
}


def _aec3_geo_pair_phase_false():
    from webrtc_audio_processing_tpu_torch.models.aec3 import (
        config as a3cfg,
        echo_canceller3 as ec3,
    )

    return ec3.Aec3Geometry.create(a3cfg.EchoCanceller3Config(), 48000, 2,
                                   2, pair_phase=False)


def _aec3_geo_nree():
    from webrtc_audio_processing_tpu_torch.models.aec3 import (
        config as a3cfg,
        echo_canceller3 as ec3,
    )

    return ec3.Aec3Geometry.create(a3cfg.EchoCanceller3Config(), 48000, 2,
                                   2, nree=object())


@pytest.mark.parametrize("name", sorted(_UNPORTED_AEC3))
def test_unported_aec3_options_raise(name):
    """AEC3 runs; its non-default branches raise, naming their item."""
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 11"):
        _UNPORTED_AEC3[name]()


def test_aec3_geometry_and_state_build():
    geo = apm.ApmGeometry.create(_aec3_config(), 48000, 2,
                                 num_render_channels=2,
                                 aec3_stereo_content=True)
    assert geo.aec3 is not None and geo.aec3.num_render_channels == 2
    assert geo.post_filter_enabled and geo.aec3_dynamic_stereo
    state = apm.init_state(geo, 2, device="cpu")
    assert state.aec is not None and state.pf is not None
    assert state.ed is not None and state.frame_counter == 0
    # The block cadence needs a render frame on every step.
    x = torch.zeros((2, 480, 2))
    with pytest.raises(ValueError, match="render frame"):
        apm.process_stream_pair(geo, state, x)


def test_init_state_defaults_to_the_card():
    """Without a device the state goes to the card; with no card that
    raises and says to pass device="cpu"."""
    _, geo = _geometries()
    if torch.cuda.is_available():
        state = apm.init_state(geo, 1)
        assert state.input_rms.sum_square.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            apm.init_state(geo, 1)
    state = apm.init_state(geo, 1, device="cpu")
    assert state.input_rms.sum_square.device.type == "cpu"


def test_rnn_vad_weights_are_a_byte_identical_copy():
    from webrtc_audio_processing_tpu_torch.models.agc2.rnn_vad import rnn

    jax_file = os.path.join(REPO, "webrtc_audio_processing_tpu", "models",
                            "agc2", "rnn_vad", "rnnoise_weights.npz")
    assert os.path.dirname(str(rnn.WEIGHTS_PATH)).endswith(
        os.path.join("webrtc_audio_processing_tpu_torch", "models", "agc2",
                     "rnn_vad"))
    with open(rnn.WEIGHTS_PATH, "rb") as a, open(jax_file, "rb") as b:
        assert a.read() == b.read()
