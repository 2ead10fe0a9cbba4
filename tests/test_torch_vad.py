"""Parity of the port's VADs with the JAX package on the CPU: the legacy
GMM VAD bit for bit at 8, 16 and 32 kHz in its four modes, and the
analytics (pitch-based) VAD in float32 within JAX's own bars against its
float64 oracle (tests/test_analytics_vad.py) and tighter ones where they
hold. The analytics VAD's IIRs run on K1's twin here (on the card, K1), in
another rounding order than JAX's scans.

Inputs are made from seeded numpy generators; the JAX functions are
vmapped over the streams and jitted once per configuration (the legacy
VAD once per rate, its mode's thresholds an argument)."""

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from webrtc_audio_processing_tpu.models.vad import analytics_vad as j_av
from webrtc_audio_processing_tpu.models.vad import legacy_vad as j_lv

from webrtc_audio_processing_tpu_torch.models.vad import analytics_vad as av
from webrtc_audio_processing_tpu_torch.models.vad import legacy_vad as lv
from webrtc_audio_processing_tpu_torch.ops import cuda_biquad

from tests.torch_agc1_util import assert_states, batched, compile_all, t

B = 3


def speechlike(rng, n, fs, amp):
    """Tone bursts at a syllable rate plus noise, one level per stream."""
    tt = np.arange(n) / fs
    out = []
    for b in range(B):
        burst = (np.sin(2 * np.pi * (3.1 + 0.4 * b) * tt) > 0.2).astype(float)
        sig = (np.sin(2 * np.pi * (220 + 60 * b) * tt)
               + 0.5 * np.sin(2 * np.pi * 1100 * tt + b))
        out.append(amp * (b + 1) / B * sig * burst
                   + rng.normal(size=n) * 300.0)
    return np.clip(np.array(out), -32768, 32767).astype(np.int32)


def voiced(rng, n, fs=16000, amp=4000.0, f0=125.0):
    """tests/test_analytics_vad.py's voiced signal: a pitch near ``f0``
    with a formant-like emphasis, plus noise."""
    tt = np.arange(n) / fs
    ph = 2 * np.pi * np.cumsum(f0 * (1 + 0.04 * np.sin(2 * np.pi * 2.7 * tt)))
    ph = ph / fs
    w = {1: 0.3, 2: 0.6, 3: 1.0, 4: 1.0, 5: 0.7, 6: 0.4}
    saw = sum(w.get(k, 1.0 / k) * np.sin(k * ph) for k in range(1, 10))
    x = saw * (0.7 + 0.3 * np.sin(2 * np.pi * 1.3 * tt))
    return amp * x / np.abs(x).max() + rng.normal(size=n) * 20.0


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-9)


# ------------------------------------------------------------ legacy VAD

_LEGACY = [(rate, mode, ms) for rate, ms in ((8000, 10), (16000, 20),
                                             (32000, 30))
           for mode in range(4)]


def _thresholds(mode, ms):
    """The mode's four GMM thresholds at the frame length ``ms``, in
    ``gmm_probability``'s order (over-hang 1 and 2, individual, total)."""
    return jnp.asarray([tbl[ms // 10 - 1] for tbl in j_lv._MODE_TABLES[mode]],
                       jnp.int32)


class _TracedThresholds(dict):
    """``legacy_vad._MODE_TABLES`` while the steps below trace: every
    mode's entry is the thresholds argument of the step this thread
    traces (XLA compiles the steps in threads)."""

    local = threading.local()

    def __getitem__(self, mode):
        th = self.local.th
        return tuple((th[i],) * 3 for i in range(4))


@pytest.fixture(scope="module")
def legacy_steps():
    """The JAX VAD of each rate, compiled side by side, one program for
    the four modes: the mode enters ``gmm_probability`` only as its four
    integer thresholds, which the program takes as an int32 argument, so
    each mode runs JAX's own integer code on its own thresholds."""
    js = batched(j_lv.init_state(), B)
    tables = _TracedThresholds()

    def step(s, a, th, rate):
        tables.local.th = th
        return j_lv.process(s, a, rate)

    real, j_lv._MODE_TABLES = j_lv._MODE_TABLES, tables
    try:
        return compile_all({
            rate: (jax.vmap(functools.partial(step, rate=rate),
                            in_axes=(0, 0, None)),
                   (js, jnp.zeros((B, rate * ms // 1000), jnp.int32),
                    jnp.zeros(4, jnp.int32)))
            for rate, ms in {(r, m) for r, _, m in _LEGACY}})
    finally:
        j_lv._MODE_TABLES = real


@pytest.mark.parametrize("rate, mode, ms", _LEGACY)
def test_legacy_vad_bit_equal(legacy_steps, rate, mode, ms):
    """WebRtcVad_Process over 12 frames of speech bursts: the decisions and
    every state leaf equal."""
    L = rate * ms // 1000
    rng = np.random.default_rng(rate + mode)
    x = speechlike(rng, L * 12, rate, 9000)
    x[:, L * 4:L * 6] //= 64  # a quiet stretch
    js = batched(j_lv.init_state(), B)
    st = lv.init_state(B, "cpu")
    step, th = legacy_steps[rate], _thresholds(mode, ms)
    flags = []
    for k in range(12):
        fr = x[:, k * L:(k + 1) * L]
        js, jf = step(js, jnp.asarray(fr), th)
        st, f = lv.LegacyVad(rate, mode)(st, t(fr))
        np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
        flags.append(f.numpy())
    assert_states(st, js)
    assert np.stack(flags).any()


# --------------------------------------------------------- analytics VAD


@pytest.fixture(scope="module")
def av_steps():
    """The JAX analytics-VAD functions the tests below hold the port to,
    compiled side by side."""
    z = lambda *s: jnp.zeros((B,) + s, jnp.float32)  # noqa: E731
    pitch = batched(j_av.init_pitch_analysis(), B)
    vad = batched(j_av.init_voice_activity_detector(), B)
    jobs = {
        "split": (jax.vmap(j_av.split_and_filter),
                  (batched(j_av.init_prefilt(), B), z(480))),
        "weight": (jax.vmap(j_av.weighting_filter),
                   (batched(j_av.init_weight_filt(), B), z(240))),
        "pitch": (jax.vmap(j_av.pitch_analysis), (pitch, z(240))),
    }
    # Only phase 2 of 3 changes the chunk's work (process_chunk).
    for ph in (0, 2):
        jobs[ph] = (jax.vmap(lambda s, f, ph=ph: j_av.process_chunk(
            s, f, ph)), (vad, jnp.zeros((B, 160), jnp.int32)))
    return compile_all(jobs)


def test_split_and_filter_within_bars(av_steps):
    """The iSAC pre-filter bank (the input HPF's poles and the all-pass
    branches on K1's twin) over 4 frames: JAX's bar 1e-4 of scale; held to
    1e-4 on the high bands, 1e-5 on the low ones."""
    rng = np.random.default_rng(20)
    x = np.stack([voiced(rng, 480 * 4, amp=3000 + 1000 * b, f0=110 + 20 * b)
                  for b in range(B)]).astype(np.float32)
    js = batched(j_av.init_prefilt(), B)
    st = av.init_prefilt(B, "cpu")
    step = av_steps["split"]
    for k in range(4):
        seg = x[:, k * 480:(k + 1) * 480]
        js, *want = step(js, jnp.asarray(seg))
        st, *got = av.split_and_filter(st, t(seg))
        for name, g, w, bar in zip(("lp", "hp", "lp_la", "hp_la"), got,
                                   want, (1e-5, 1e-4, 1e-5, 1e-4)):
            assert rel(g.numpy(), w) < bar, (k, name, rel(g.numpy(), w))
    assert_states(st, js, rtol=1e-4)


def test_weighting_filter_within_bars(av_steps):
    """The LPC weighting filter (its 6th-order all-pole a loop over each
    subframe's 60 samples) over 6 frames: JAX's bar 5e-3, held to 1e-4."""
    rng = np.random.default_rng(21)
    x = np.stack([voiced(rng, 240 * 6, fs=8000, amp=3000 + 500 * b,
                         f0=100 + 30 * b) for b in range(B)]).astype(
        np.float32)
    js = batched(j_av.init_weight_filt(), B)
    st = av.init_weight_filt(B, "cpu")
    step = av_steps["weight"]
    for k in range(6):
        seg = x[:, k * 240:(k + 1) * 240]
        js, jwe, jwh = step(js, jnp.asarray(seg))
        st, we, wh = av.weighting_filter(st, t(seg))
        scale = np.abs(np.asarray(jwe)).max() + np.abs(seg).max()
        assert np.abs(we.numpy() - jwe).max() / scale < 1e-4, k
        assert np.abs(wh.numpy() - jwh).max() / scale < 1e-4, k
    assert_states(st, js, rtol=1e-3)


def test_pitch_analysis_within_bars(av_steps):
    """The iSAC pitch estimator over 8 frames: JAX's bar is the same lags
    (within 1) and gains within 0.05; held to lags within 1e-3 and gains
    within 1e-4 on every frame."""
    rng = np.random.default_rng(22)
    x = np.stack([voiced(rng, 240 * 8, fs=8000, amp=3000 + 500 * b,
                         f0=100 + 30 * b) for b in range(B)]).astype(
        np.float32)
    js = batched(j_av.init_pitch_analysis(), B)
    st = av.init_pitch_analysis(B, "cpu")
    step = av_steps["pitch"]
    for k in range(8):
        seg = x[:, k * 240:(k + 1) * 240]
        js, jl, jg = step(js, jnp.asarray(seg))
        st, lags, gains = av.pitch_analysis(st, t(seg))
        assert np.abs(lags.numpy() - jl).max() < 1e-3, k
        assert np.abs(gains.numpy() - jg).max() < 1e-4, k
    assert_states(st, js, rtol=1e-3)


def test_voice_activity_detector_within_bars(av_steps):
    """VoiceActivityDetector::ProcessChunk over 36 chunks at its 30 ms
    cadence (speech, noise, quieter higher speech): JAX's chain bar is
    0.05 on the probabilities; held to 1e-3, the RMS to 1e-5 of scale, and
    the state's float leaves to 1e-3 of each leaf's scale, its integer
    leaves (the standalone VAD's) exact."""
    rng = np.random.default_rng(23)
    n = 160 * 36
    x = np.stack([voiced(rng, n, amp=4000.0), rng.normal(size=n) * 80.0,
                  voiced(rng, n, amp=1500.0, f0=180.0)]).astype(np.int32)
    js = batched(j_av.init_voice_activity_detector(), B)
    st = av.init_voice_activity_detector(B, "cpu")
    steps = [av_steps[ph] for ph in (0, 0, 2)]
    module = av.AnalyticsVad()
    probs = []
    for k in range(36):
        fr = x[:, k * 160:(k + 1) * 160]
        js, jp, jr, _ = steps[k % 3](js, jnp.asarray(fr))
        st, p, r, valid = module(st, t(fr), k % 3)
        assert valid == (k % 3 == 2)
        assert np.abs(p.numpy() - jp).max() < 1e-3, k
        assert rel(r.numpy(), jr) < 1e-5, k
        if valid:
            probs.append(p.numpy())
    assert_states(st, js, rtol=1e-3)
    probs = np.stack(probs)[-4:]
    # Speech is voiced; the noise stream is not.
    assert probs[:, 0].mean() > 0.5 and probs[:, 1].mean() < 0.1, probs


def test_analytics_iirs_run_on_k1(monkeypatch):
    """A phase-2 chunk runs ten K1 cascades (the pole-zero HPF, five in the
    pre-filter bank, four in the pitch analysis), the other chunks one (the
    HPF);
    counted through the wrapper's dispatch on the CPU."""
    calls = []
    real = cuda_biquad.cascade

    def counting(coeffs, state, x_t, allpass=False):
        calls.append((tuple(coeffs.shape), tuple(x_t.shape), allpass))
        return real(coeffs, state, x_t, allpass)

    monkeypatch.setattr(cuda_biquad, "cascade", counting)
    st = av.init_voice_activity_detector(2, "cpu")
    fr = t(np.random.default_rng(24).integers(-3000, 3000, (2, 160)).astype(
        np.int32))
    per_phase = []
    for ph in range(3):
        calls.clear()
        st, *_ = av.process_chunk(st, fr, ph)
        per_phase.append(len(calls))
    assert per_phase == [1, 1, 10], per_phase
    # All-pass: the composite pair, the two branches, the decimator's two.
    assert sum(a for _, _, a in calls) == 6
