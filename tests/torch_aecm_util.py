"""Shared set-up of the AECM APM parity tests (tests/test_torch_aecm_apm.py
and tests/test_torch_aecm_rates.py): the reference's fixed profile
(``WEBRTC_AUDIOPROC_FIXED_PROFILE``: AECM in mobile mode, AGC1 adaptive
digital, NS, HPF; tools/apm_conformance.py:75-88), its echo scenes, and
both packages run free on them, the AGC1 level fed back on each side, with
one port step from JAX's state before every frame. The JAX steps of the
cases asked for compile side by side."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from tests import torch_threads  # noqa: F401  (one thread a worker)
import chip_smoke

from webrtc_audio_processing_tpu import apm as j_apm
from webrtc_audio_processing_tpu import config as j_cfg
from webrtc_audio_processing_tpu.models.agc1 import gain_control as j_gc

from webrtc_audio_processing_tpu_torch import apm
from webrtc_audio_processing_tpu_torch import config as cfg_mod
from webrtc_audio_processing_tpu_torch.models.agc1 import gain_control

from tests.torch_agc1_util import assert_states, batched, compile_all, t

RTOL_RMS = 1e-3
# name: (rate, channels, streams, frames, delays ms)
CASES = {
    "fixed_16k": (16000, 1, 2, 30, (20, 50)),
    "fixed_32k": (32000, 1, 1, 12, (30,)),
    "fixed_8k": (8000, 1, 2, 12, (30, 30)),
}


def fixed_profile(m):
    return m.Config().replace(
        pipeline=m.Pipeline(maximum_internal_processing_rate=48000),
        echo_canceller=m.EchoCanceller(enabled=True, mobile_mode=True),
        gain_controller1=m.GainController1(
            enabled=True, mode=m.Agc1Mode.ADAPTIVE_DIGITAL,
            analog_gain_controller=m.AnalogGainController(enabled=False)),
        noise_suppression=m.NoiseSuppression(enabled=True),
        high_pass_filter=m.HighPassFilter(enabled=True))


def geometry(m, name):
    rate, ch = CASES[name][:2]
    return m.ApmGeometry.create(
        fixed_profile(cfg_mod if m is apm else j_cfg), rate, ch,
        render_input_rate=rate, num_render_channels=ch)


def scene(name):
    """(B, n, C) far and near ends in [-1, 1]: tests/test_aecm_apm.py's
    speech-like far end per stream and channel, its echo at the stream's
    delay with tests/test_aecm.py's smear; a voiced near end at 0.1 of full
    scale on stream 1."""
    rate, ch, B, n_frames, delays = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    n = n_frames * rate // 100
    tt = np.arange(n) / rate
    burst = (np.sin(2 * np.pi * 2.7 * tt) > -0.3)
    level = 0.08 + 0.92 * np.abs(np.sin(2 * np.pi * 0.31 * tt))
    far = rng.normal(size=(B, n, ch)) * 0.28 * (burst * level)[:, None]
    near = np.zeros_like(far)
    for b, d in enumerate(delays):
        s = d * rate // 1000 + rate // 100
        fd = np.roll(far[b], s, 0)
        near[b] = 0.5 * fd + 0.2 * np.roll(fd, 1, 0) + 0.1 * np.roll(fd, 2, 0)
    if B > 1:
        near[1] += chip_smoke.voiced_near_end(n, rate, 3, 0.1)[:, None]
    return far.astype(np.float32), near.astype(np.float32)


def jax_step(jgeo):
    def fn(s, c, r, v, d):
        if s.agc1 is not None:
            s = s.replace(agc1=j_gc.set_stream_analog_level(s.agc1, v))
        return j_apm.process_stream_pair(jgeo, s, c, r, 0,
                                         stream_delay_ms=d,
                                         applied_input_volume=v)
    return jax.vmap(fn)


def port_step(geo, state, c, r, delay, level):
    if state.agc1 is not None:
        state = dataclasses.replace(
            state, agc1=gain_control.set_stream_analog_level(state.agc1,
                                                             t(level)))
    return apm.process_stream_pair(geo, state, t(c), t(r),
                                   stream_delay_ms=t(delay),
                                   applied_input_volume=t(level))


def run_cases(names):
    """Each case of ``names`` free-running in both packages, the AGC1
    level fed back on each side, and one port step from JAX's state before
    each frame."""
    jobs, jgeos = {}, {}
    for name in names:
        rate, ch, B, _, delays = CASES[name]
        jgeo = jgeos[name] = geometry(j_apm, name)
        js = batched(j_apm.init_state(jgeo), B)
        F = rate // 100
        z = np.zeros((B, F, ch), np.float32)
        jobs[name] = (jax_step(jgeo), (js, z, z, jnp.zeros(B, jnp.int32),
                                        np.array(delays, np.int32)))
    steps = compile_all(jobs)
    out = {}
    for name in names:
        rate, ch, B, n_frames, delays = CASES[name]
        geo = geometry(apm, name)
        F = rate // 100
        far, near = scene(name)
        delay = np.array(delays, np.int32)
        js = jax.tree_util.tree_map(np.asarray,
                                    batched(j_apm.init_state(jgeos[name]), B))
        state = apm.state_from_jax(js, geo)
        jl = pl = np.full(B, 100, np.int32)
        r = {"jax": [], "torch": [], "one_step": [], "jax_level": [],
             "torch_level": [], "aecm_equal": [], "startup": [],
             "far": far, "near": near}
        for f in range(n_frames):
            c, x = near[:, f * F:(f + 1) * F], far[:, f * F:(f + 1) * F]
            one = apm.state_from_jax(js, geo, f)
            _, y1, _, _ = port_step(geo, one, c, x, delay, jl)
            js, jy, _, jst = steps[name](js, c, x, jnp.asarray(jl), delay)
            js = jax.tree_util.tree_map(np.asarray, js)
            state, y, _, st = port_step(geo, state, c, x, delay, pl)
            if "agc1_recommended_level" in jst:
                jl = np.asarray(jst["agc1_recommended_level"])
                pl = st["agc1_recommended_level"].numpy()
            r["jax"].append(np.asarray(jy))
            r["torch"].append(y.numpy())
            r["one_step"].append(y1.numpy())
            r["jax_level"].append(jl)
            r["torch_level"].append(pl)
            try:
                assert_states(state.aecm, js.aecm)
                r["aecm_equal"].append(True)
            except AssertionError:
                r["aecm_equal"].append(False)
            r["startup"].append(bool(js.aecm.ec_startup.any()))
        r["geo"] = geo
        out[name] = r
    return out


def rel_rms(got, want):
    """Relative RMS per stream over frames, samples and channels."""
    got, want = np.stack(got), np.stack(want)
    return np.sqrt(((got - want) ** 2).sum(axis=(0, 2, 3))
                   / np.maximum((want ** 2).sum(axis=(0, 2, 3)), 1e-20))
