"""Parity of the port's AGC1 with the JAX package on the CPU, bit for bit:
the SPL primitives, the digital AGC (gain table, AGC VAD, gain computation
with the limiter's twin, gain application), the analog AGC in its three
modes, the GainControlImpl front and AgcManagerDirect's decision layer.

Inputs are made from seeded numpy generators; the JAX functions are
vmapped over the streams and jitted once per configuration."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webrtc_audio_processing_tpu import config as j_cfg
from webrtc_audio_processing_tpu.models.agc1 import (
    agc_manager_direct as j_amd,
    analog as j_analog,
    digital as j_digital,
    gain_control as j_gc,
)
from webrtc_audio_processing_tpu.ops import spl as j_spl

from webrtc_audio_processing_tpu_torch import config as cfg_mod
from webrtc_audio_processing_tpu_torch.models.agc1 import (
    agc_manager_direct as amd,
    analog,
    digital,
    gain_control as gc,
)
from webrtc_audio_processing_tpu_torch.ops import cuda_agc1_limiter, spl

from tests.torch_agc1_util import assert_states, batched, compile_all, t

B = 3


def speechlike(rng, n, amp, streams=B):
    """Bursts of two tones plus noise, one amplitude per stream, int32."""
    tt = np.arange(n) / 16000
    out = []
    for b in range(streams):
        burst = (np.sin(2 * np.pi * (2.3 + 0.3 * b) * tt) > 0).astype(float)
        sig = (np.sin(2 * np.pi * (311 + 40 * b) * tt)
               + 0.6 * np.sin(2 * np.pi * 650 * tt + 1))
        out.append(amp * (b + 1) / streams * sig * burst
                   + rng.integers(-200, 200, n))
    return np.clip(np.array(out), -32768, 32767).astype(np.int32)


# ------------------------------------------------------------------- spl

_EDGE = np.array([-2**31, 2**31 - 1, 0, 1, -1, 2**30, -2**30, 32767,
                  -32768, 65535, 123456789, -987654321], np.int64)


def _ints():
    rng = np.random.default_rng(0)
    x = np.concatenate([_EDGE, rng.integers(-2**31, 2**31, 4000)])
    y = np.concatenate([_EDGE[::-1], rng.integers(-2**31, 2**31, 4000)])
    y16 = np.concatenate([[1, -1, 32767, -32768, 0, 5, 7, 100, -100, 3,
                           60255, 37471], rng.integers(-32768, 32768, 4000)])
    return x.astype(np.int32), y.astype(np.int32), y16.astype(np.int32)


_SPL = {
    "norm_u32": lambda x, y, s: (x,),
    "norm_w32": lambda x, y, s: (x,),
    "div_w32_w16": lambda x, y, s: (x, s),
    "mul_hi16": lambda x, y, s: (x, s),
    "scalediff32": lambda x, y, s: (np.abs(s), x, y),
    "agc_scalediff32": lambda x, y, s: (s, x, y),
    "agc_mul32": lambda x, y, s: (x, y),
    "sqrt_i32": lambda x, y, s: (x,),
}


@pytest.mark.parametrize("name", sorted(_SPL))
def test_spl_elementwise_bit_equal(name):
    """Every primitive at int32's extremes, 0, +-1 and 4000 random values,
    products that wrap included."""
    args = _SPL[name](*_ints())
    want = np.asarray(getattr(j_spl, name)(*map(jnp.asarray, args)))
    got = getattr(spl, name)(*map(t, args)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_spl_downsample_by_2_bit_equal():
    rng = np.random.default_rng(1)
    x = rng.integers(-32768, 32768, (B, 160)).astype(np.int32)
    st = rng.integers(-2**20, 2**20, (B, 8)).astype(np.int32)
    jy, jst = jax.vmap(j_spl.downsample_by_2)(jnp.asarray(x), jnp.asarray(st))
    y, st2 = spl.downsample_by_2(t(x), t(st))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(st2.numpy(), np.asarray(jst))


# --------------------------------------------------------------- digital


@pytest.mark.parametrize("comp, target, limiter, analog_target", [
    (9, 3, True, 11), (0, 0, False, 0), (90, 31, True, 45), (7, 2, True, 7)])
def test_gain_table_equals_jax(comp, target, limiter, analog_target):
    np.testing.assert_array_equal(
        digital.calculate_gain_table(comp, target, limiter, analog_target),
        j_digital.calculate_gain_table(comp, target, limiter, analog_target))


def _i32(*shape):
    return jnp.zeros(shape, jnp.int32)


_WORST_GAIN = int(digital.calculate_gain_table(90, 0, True, 90).max())
_FIXED = digital.AGC_MODE_FIXED_DIGITAL
_MODES = {"adaptive_analog": 1, "adaptive_digital": 2, "fixed_digital": 3}
_GC_MODES = {"adaptive_analog": "ADAPTIVE_ANALOG",
             "adaptive_digital": "ADAPTIVE_DIGITAL",
             "fixed_digital": "FIXED_DIGITAL"}
MGR_C = 2


def _vad_job(length):
    return (jax.vmap(j_digital.process_vad),
            (batched(j_digital.init_vad(), B), _i32(B, length)))


def _limiter_job():
    table = jnp.full((32,), _WORST_GAIN, jnp.int32)
    return (jax.vmap(lambda s, b: j_digital.compute_digital_gains(
        s, b, _FIXED, table, jnp.asarray(False))),
        (batched(j_digital.init_digital(_FIXED), B), _i32(B, 160)))


def _analog_job(m):
    cfg = j_analog.LegacyAgcConfig(agc_mode=m)

    def jstep(s, fr, lvl):
        if m == 2:
            s, bands, lvl = j_analog.virtual_mic(cfg, s, fr[None], lvl)
        else:
            s, bands = j_analog.add_mic(cfg, s, fr[None])
        s, g, lvl2, warn = j_analog.analyze(cfg, s, bands, lvl, 0)
        return s, j_analog.process(g, bands), lvl2, warn

    return (jax.vmap(jstep), (batched(j_analog.init_state(cfg), B),
                              _i32(B, 160), _i32(B)))


def _gc_config(m, name):
    return m.GainController1(enabled=True, mode=getattr(m.Agc1Mode, name))


def _gc_job(name):
    jc = j_gc.make_config(_gc_config(j_cfg, name), 16000)

    def jstep(s, bands, r):
        s = j_gc.process_render_audio(jc, s, r)
        s, bands = j_gc.analyze_capture_audio(jc, s, bands)
        s, y = j_gc.process_capture_audio(jc, s, bands, False)
        return s, y, j_gc.shared_gains(s)

    return (jax.vmap(jstep), (batched(j_gc.init_state(jc, 2), B),
                              _i32(B, 1, 160, 2), _i32(B, 160)))


def _jax_vad_stub(st, frame, phase):
    """The JAX manager's analytics VAD replaced: its outputs ride in on the
    (otherwise unused) ring of the VAD state, set by ``_mgr_job``'s step."""
    ring = st.pitch_vad.ring
    return (st.replace(last_probability=ring[2]), ring[:3], ring[3:6],
            jnp.asarray(phase == 2))


def _stub_vad(module, fn):
    """A copy of ``module`` whose ``process_chunk`` is ``fn``."""
    ns = types.SimpleNamespace(**vars(module))
    ns.process_chunk = fn
    return ns


def _mgr_job(phase, dda):
    def jstep(s, fr, lvl, p, r):
        vad = s.monos.agc.vad
        vad = vad.replace(pitch_vad=vad.pitch_vad.replace(
            ring=vad.pitch_vad.ring.at[:, :6].set(
                jnp.concatenate([p, r], -1))))
        s = s.replace(monos=s.monos.replace(agc=s.monos.agc.replace(
            vad=vad)))
        s = j_amd.set_stream_analog_level(s, lvl)
        s = j_amd.analyze_pre_process(s, fr)
        b0 = jnp.clip(jnp.trunc(fr + jnp.copysign(0.5, fr)), -32768,
                      32767).astype(jnp.int32)
        return j_amd.process(s, b0, phase, disable_digital_adaptive=dda)

    f32 = lambda *sh: jnp.zeros(sh, jnp.float32)  # noqa: E731
    return (jax.vmap(jstep), (batched(j_amd.init_state(MGR_C), B),
                              f32(B, 160, MGR_C), _i32(B),
                              f32(B, MGR_C, 3), f32(B, MGR_C, 3)))


@pytest.fixture(scope="module")
def steps():
    """Every JAX step the tests below hold the port to, compiled side by
    side; the manager's with its analytics VAD stubbed while it traces."""
    jobs = {("vad", n): _vad_job(n) for n in (160, 80)}
    jobs["limiter"] = _limiter_job()
    jobs.update({("analog", m): _analog_job(m) for m in _MODES.values()})
    jobs.update({("gc", n): _gc_job(n) for n in _GC_MODES.values()})
    # The manager reads the phase only as ``phase == 2`` (agc_process).
    jobs.update({("mgr", ph, dda): _mgr_job(ph, dda) for ph in (0, 2)
                 for dda in (False, True)})
    real = j_amd.analytics_vad
    j_amd.analytics_vad = _stub_vad(real, _jax_vad_stub)
    try:
        return compile_all(jobs)
    finally:
        j_amd.analytics_vad = real


@pytest.mark.parametrize("length", [160, 80])
def test_agc_vad_bit_equal(steps, length):
    """WebRtcAgc_ProcessVad on 16 kHz bands and 8 kHz frames, 20 frames."""
    rng = np.random.default_rng(2)
    x = speechlike(rng, length * 20, 12000)
    js = batched(j_digital.init_vad(), B)
    st = digital.init_vad(B, "cpu")
    step = steps[("vad", length)]
    for k in range(20):
        fr = x[:, k * length:(k + 1) * length]
        js, jr = step(js, jnp.asarray(fr))
        st, r = digital.process_vad(st, t(fr))
        np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    assert_states(st, js)


def test_limiter_twin_at_worst_case_gains(steps):
    """The limiter at its worst case over AGC1's configuration range
    (tools/torch_agc1_limiter_worst.py: 727 passes, the largest gain of the
    fixed-digital table at 90 dB compression and target 0, on an
    envelope of 2^25): a table of that gain alone (so the gate keeps it)
    on square waves at the envelope's level and at full scale. The gains
    and the state equal JAX's, and the loop ran its longest."""
    table = np.full(32, _WORST_GAIN, np.int32)
    amp = np.array([5792, 32767, 4096])
    x = np.zeros((B, 160 * 3), np.int32)
    x[:, 0::2] = amp[:, None]
    x[:, 1::2] = -amp[:, None]
    js = batched(j_digital.init_digital(_FIXED), B)
    st = digital.init_digital(_FIXED, B, "cpu")
    low = torch.zeros(B, dtype=torch.bool)
    for k in range(3):
        fr = x[:, k * 160:(k + 1) * 160]
        js, jg = steps["limiter"](js, jnp.asarray(fr))
        st, g = digital.compute_digital_gains(st, t(fr), _FIXED, t(table),
                                              low)
        np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    assert_states(st, js)
    # Row 0's loop ran ~727 passes: 0.1 dB each from the worst gain.
    drop_db = 20 * np.log10(_WORST_GAIN / float(g[0, 5]))
    assert drop_db > 70.0, drop_db


def _w32(v):
    return (v + 2**31) % 2**32 - 2**31


def _scalar_limit(g, e):
    """digital_agc.cc:439-476 on Python ints, int32 wraps explicit."""
    def norm_w32(x):
        if x == 0:
            return 0
        ax = ~x if x < 0 else x
        return (31 if ax == 0 else 32 - ax.bit_length()) - 1

    while True:
        zeros = 16 - norm_w32(g) if g > 47452159 else 10
        gain32 = _w32(((g >> zeros) + 1) ** 2)
        a = (e >> 12) + 1
        lhs = _w32(_w32((gain32 >> 13) * a) + (_w32((gain32 & 0x1FFF) * a)
                                                >> 13))
        shift = 2 * (1 - zeros + 10)
        rhs = 32767 << shift if shift >= 0 else 32767 >> -shift
        if lhs <= rhs:
            return g
        g = (g // 256) * 253 if g > 8388607 else _w32(g * 253) // 256


def test_limiter_twin_equals_a_scalar_loop():
    """The twin against the reference loop on Python ints, gains drawn from
    a 40 dB table, envelopes up to full scale; then the backward minimum."""
    rng = np.random.default_rng(3)
    table = digital.calculate_gain_table(40, 3, True, 20)
    gains = rng.choice(table, (16, 11)).astype(np.int32)
    env = rng.integers(0, 2**30, (16, 10)).astype(np.int32)
    want = np.array([[_scalar_limit(int(g), int(e))
                      for g, e in zip(gr[1:], er)]
                     for gr, er in zip(gains, env)])
    want = np.minimum.accumulate(want[:, ::-1], axis=1)[:, ::-1]
    got = cuda_agc1_limiter.limit(t(gains), t(env)).numpy()
    np.testing.assert_array_equal(got[:, 1:], want)
    np.testing.assert_array_equal(got[:, 0], gains[:, 0])


def test_apply_digital_gains_bit_equal():
    rng = np.random.default_rng(4)
    gains = rng.integers(0, 2**22, (B, 11)).astype(np.int32)
    bands = rng.integers(-32768, 32768, (B, 2, 160)).astype(np.int32)
    want = jax.vmap(j_digital.apply_digital_gains)(jnp.asarray(gains),
                                                   jnp.asarray(bands))
    got = digital.apply_digital_gains(t(gains), t(bands))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------- analog


@pytest.mark.parametrize("mode", sorted(_MODES))
def test_analog_agc_bit_equal(steps, mode):
    """AddMic (or VirtualMic), Analyze and Process over 30 frames, the
    level following each package's recommendation: outputs, levels and
    every state leaf equal."""
    m = _MODES[mode]
    cfg = j_analog.LegacyAgcConfig(agc_mode=m)
    pcfg = analog.LegacyAgcConfig(agc_mode=m)
    step = steps[("analog", m)]
    rng = np.random.default_rng(5)
    x = speechlike(rng, 160 * 30, 20000)
    js = batched(j_analog.init_state(cfg), B)
    st = analog.init_state(pcfg, B, "cpu")
    lvl = np.full(B, 100, np.int32)
    for k in range(30):
        fr = x[:, k * 160:(k + 1) * 160]
        js, jo, jl, jw = step(js, jnp.asarray(fr), jnp.asarray(lvl))
        bands = t(fr)[:, None]
        plvl = t(lvl)
        if m == 2:
            st, bands, plvl = analog.virtual_mic(pcfg, st, bands, plvl)
        else:
            st, bands = analog.add_mic(pcfg, st, bands)
        st, g, pl, pw = analog.analyze(pcfg, st, bands, plvl, 0)
        np.testing.assert_array_equal(analog.process(g, bands)[:, 0].numpy(),
                                      np.asarray(jo)[:, 0])
        np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(pw.numpy(), np.asarray(jw))
        lvl = np.asarray(jl)
    assert_states(st, js)


# ---------------------------------------------------------- gain control


@pytest.mark.parametrize("mode", sorted(_GC_MODES))
def test_gain_control_front_bit_equal(steps, mode):
    """GainControlImpl with two capture channels: the render analysis, the
    capture analysis, Analyze and Process over 20 frames; outputs, the
    shared gains and every state leaf equal."""
    name = _GC_MODES[mode]
    jc = j_gc.make_config(_gc_config(j_cfg, name), 16000)
    pc = gc.make_config(_gc_config(cfg_mod, name), 16000)
    step = steps[("gc", name)]
    rng = np.random.default_rng(6)
    x = speechlike(rng, 160 * 20, 9000, streams=2 * B)
    far = speechlike(rng, 160 * 20, 3000)

    js = batched(j_gc.init_state(jc, 2), B)
    js = jax.vmap(j_gc.set_stream_analog_level)(js, jnp.arange(B) * 40 + 60)
    st = gc.set_stream_analog_level(gc.init_state(pc, 2, B, "cpu"),
                                    torch.arange(B) * 40 + 60)
    for k in range(20):
        fr = x[:, k * 160:(k + 1) * 160].reshape(B, 2, 160)
        bands = np.ascontiguousarray(fr.transpose(0, 2, 1))[:, None]
        r = far[:, k * 160:(k + 1) * 160]
        js, jy, jg = step(js, jnp.asarray(bands), jnp.asarray(r))
        st = gc.process_render_audio(pc, st, t(r))
        st, b2 = gc.analyze_capture_audio(pc, st, t(bands))
        st, y = gc.process_capture_audio(pc, st, b2, False)
        np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
        np.testing.assert_array_equal(gc.shared_gains(st).numpy(),
                                      np.asarray(jg))
    assert_states(st, js)


def test_float_gain_application_matches_jax():
    """GainControlImpl's float ApplyDigitalGain on split bands: within
    float32 rounding (XLA may fuse the ramp's multiply-add)."""
    rng = np.random.default_rng(7)
    gains = rng.integers(30000, 300000, (B, 11)).astype(np.int32)
    bands = (rng.standard_normal((B, 2, 160, 2)) * 8000).astype(np.float32)
    want = np.asarray(jax.vmap(j_gc.apply_digital_gain_float)(
        jnp.asarray(gains), jnp.asarray(bands)))
    got = gc.apply_digital_gain_float(t(gains), t(bands)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-3)


# ------------------------------------------------------ AgcManagerDirect


@pytest.mark.parametrize("disable_digital_adaptive", [False, True])
def test_agc_manager_direct_bit_equal(steps, monkeypatch,
                                      disable_digital_adaptive):
    """AgcManagerDirect with two channels over 240 frames (80 analytics
    updates of each phase): the clipping pre-analysis, the loudness
    histogram, MonoAgc's gain and volume updates and the compressor slew
    fed the same seeded analytics-VAD outputs (quiet speech on stream 0,
    loud on stream 1, silence then speech on stream 2, clipping bursts):
    recommended volumes, compression, voice probability and every state
    leaf but the analytics VAD's equal. The analytics VAD itself is held
    to JAX in tests/test_torch_vad.py."""
    rng = np.random.default_rng(8)
    n_frames, C = 240, MGR_C
    probs = np.clip(rng.normal(0.85, 0.15, (n_frames, B, C, 3)), 0, 1)
    probs[:40, 2] = 0.05
    probs[rng.random((n_frames, B, C, 3)) < 0.05] = 0.1  # short transients
    rms = np.empty((n_frames, B, C, 3))
    rms[:, 0] = 10 ** rng.normal(1.6, 0.1, (n_frames, C, 3))
    rms[:, 1] = 10 ** rng.normal(3.8, 0.1, (n_frames, C, 3))
    rms[:, 2] = 10 ** rng.normal(2.7, 0.3, (n_frames, C, 3))
    probs, rms = probs.astype(np.float32), rms.astype(np.float32)
    audio = (rng.standard_normal((n_frames, B, 160, C)) * 3000).astype(
        np.float32)
    audio[[30, 31, 32, 120], 1] = 40000.0  # clipping on stream 1
    cur = {}

    def port_vad(st, frame, phase):
        k = cur["k"]
        p = t(probs[k]).reshape(B * C, 3)
        r = t(rms[k]).reshape(B * C, 3)
        st = st.replace(last_probability=p[:, 2].contiguous())
        return st, p, r, phase == 2

    monkeypatch.setattr(amd, "analytics_vad",
                        _stub_vad(amd.analytics_vad, port_vad))
    mgr_steps = [steps[("mgr", ph, disable_digital_adaptive)]
                 for ph in (0, 0, 2)]
    js = batched(j_amd.init_state(C), B)
    st = amd.init_state(C, B, "cpu")
    lvl = np.array([100, 200, 150], np.int32)
    first_level = lvl.copy()
    for k in range(n_frames):
        cur["k"] = k
        fr = np.clip(audio[k], -32768, 32767)
        js, jv, jc, jp = mgr_steps[k % 3](js, jnp.asarray(fr),
                                          jnp.asarray(lvl),
                                          jnp.asarray(probs[k]),
                                          jnp.asarray(rms[k]))
        st = amd.set_stream_analog_level(st, t(lvl))
        st = amd.analyze_pre_process(st, t(fr))
        x = t(fr)
        b0 = torch.clamp(torch.trunc(x + torch.copysign(
            torch.full_like(x, 0.5), x)), -32768, 32767).to(torch.int32)
        st, v, c, p = amd.process(
            st, b0, k % 3, disable_digital_adaptive=disable_digital_adaptive)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
        lvl = np.asarray(jv)
    assert_states(st, js, skip=("monos.agc.vad",))
    # The loop acted: quiet speech raised its level, loud speech and the
    # clipping lowered theirs.
    assert lvl[0] > first_level[0] and lvl[1] < first_level[1], lvl
