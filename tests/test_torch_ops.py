"""Parity of the port's DSP ops with the JAX package on the CPU.

Each test feeds the same seeded numpy inputs (and the same state) to the
JAX function, jitted and vmapped over streams, and to its batch-first
counterpart in ``webrtc_audio_processing_tpu_torch``. On the CPU the port's
kernel wrappers run their plain twins.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webrtc_audio_processing_tpu.models import audio_buffer as j_ab
from webrtc_audio_processing_tpu.models import high_pass_filter as j_hpf
from webrtc_audio_processing_tpu.models import rms_level as j_rms
from webrtc_audio_processing_tpu.ops import audio_util as j_au
from webrtc_audio_processing_tpu.ops import fast_math as j_fm
from webrtc_audio_processing_tpu.ops import gain_ramp as j_gr
from webrtc_audio_processing_tpu.ops import mixed_fft as j_mixed
from webrtc_audio_processing_tpu.ops import pallas_biquad as j_pb
from webrtc_audio_processing_tpu.ops import resampler as j_rs
from webrtc_audio_processing_tpu.ops import three_band as j_tb
from webrtc_audio_processing_tpu.config import DownmixMethod as JDownmix

from webrtc_audio_processing_tpu_torch.config import DownmixMethod
from webrtc_audio_processing_tpu_torch.models import audio_buffer
from webrtc_audio_processing_tpu_torch.models import high_pass_filter as hpf
from webrtc_audio_processing_tpu_torch.models import rms_level
from webrtc_audio_processing_tpu_torch.ops import (
    audio_util,
    biquad,
    cuda_biquad,
    cuda_window,
    fast_math,
    gain_ramp,
    mixed_fft,
    mxu_fft,
    resampler,
    three_band,
)

B, C = 3, 2


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _vmap_jit(fn):
    return jax.jit(jax.vmap(fn))


# ------------------------------------------------------------- fast_math


def test_fast_math_bit_tricks_match_exactly():
    rng = np.random.default_rng(0)
    x = (np.abs(rng.standard_normal(50000)) * 10.0 ** rng.uniform(
        -8, 8, 50000)).astype(np.float32) + np.float32(1e-30)
    for name in ("fast_log2", "log_approx"):
        want = np.asarray(jax.jit(getattr(j_fm, name))(x))
        got = getattr(fast_math, name)(_t(x)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert np.float32(fast_math._FAST_LOG2_10) == np.float32(j_fm._FAST_LOG2_10)
    assert np.float32(fast_math._EXP_BIAS) == np.float32(j_fm._EXP_BIAS)


def test_exp_approx_matches_within_xla_exp2_rounding():
    # The argument x*log10(e)*FastLog2(10) is formed identically; XLA:CPU
    # then evaluates exp2(t) as exp(t * ln2) in float32, whose product
    # rounding costs up to |t| * 2^-24 relative (6.7e-6 at |t| ~ 70), while
    # torch.exp2 is correctly rounded to within an ulp (ROADMAP Queue 3).
    rng = np.random.default_rng(1)
    y = rng.uniform(-50, 50, 50000).astype(np.float32)
    want = np.asarray(jax.jit(j_fm.exp_approx)(y))
    got = fast_math.exp_approx(_t(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


# ------------------------------------------------------------- audio_util


@pytest.mark.parametrize("name", [
    "s16_to_float", "float_to_s16", "float_s16_to_s16", "float_to_float_s16",
    "float_s16_to_float", "s16_to_float_s16", "db_to_ratio",
    "dbfs_to_float_s16", "float_s16_to_dbfs",
])
def test_audio_util_conversions_match(name):
    """The sample conversions match exactly. The dB conversions go through
    float32 pow and log10, which XLA:CPU and torch approximate differently:
    both sides of 10^(x/20) stay within 1e-6 relative of float64 (rtol
    2e-6), and 20*log10(v) differs by under 2e-5 dB (atol 5e-5 dB)."""
    rng = np.random.default_rng(12)
    inputs = {
        "s16": rng.integers(-32768, 32768, 4000).astype(np.int16),
        "float": rng.uniform(-1.3, 1.3, 4000).astype(np.float32),
        "float_s16": rng.uniform(-40000, 40000, 4000).astype(np.float32),
        "db": rng.uniform(-100, 10, 4000).astype(np.float32),
    }
    arg = {"s16_to_float": "s16", "s16_to_float_s16": "s16",
           "float_to_s16": "float", "float_to_float_s16": "float",
           "float_s16_to_s16": "float_s16", "float_s16_to_float": "float_s16",
           "float_s16_to_dbfs": "float_s16", "db_to_ratio": "db",
           "dbfs_to_float_s16": "db"}[name]
    x = inputs[arg]
    if name == "float_s16_to_dbfs":
        x = np.abs(x)
    want = np.asarray(jax.jit(getattr(j_au, name))(x))
    got = getattr(audio_util, name)(_t(x)).numpy()
    assert got.dtype == want.dtype
    if name in ("db_to_ratio", "dbfs_to_float_s16"):
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=0)
    elif name == "float_s16_to_dbfs":
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)
    else:
        np.testing.assert_array_equal(got, want)


def test_audio_util_downmix_matches():
    x = np.random.default_rng(13).standard_normal((B, 480, C)).astype(
        np.float32)
    np.testing.assert_allclose(
        audio_util.downmix_average(_t(x)).numpy(),
        np.asarray(jax.jit(lambda v: j_au.downmix_average(v, axis=-1))(x)),
        rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(
        audio_util.downmix_first_channel(_t(x)).numpy(),
        np.asarray(j_au.downmix_first_channel(x, axis=-1)))


# ------------------------------------------------------------- gain ramps


def test_gain_ramps_match():
    rng = np.random.default_rng(2)
    prev = rng.uniform(0.1, 4.0, B).astype(np.float32)
    target = rng.uniform(0.1, 4.0, B).astype(np.float32)
    for j_fn, fn in ((j_gr.ramped_gains_applier, gain_ramp.ramped_gains_applier),
                     (j_gr.ramped_gains_scaler, gain_ramp.ramped_gains_scaler)):
        want = np.asarray(_vmap_jit(lambda p, t, f=j_fn: f(p, t, 480))(
            prev, target))
        got = fn(_t(prev), _t(target), 480).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------- K1 / HPF


def _hpf_frames(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n * 480) / 48000.0
    f0 = rng.uniform(60, 400, (B, 1, C))
    x = 8000.0 * np.sin(2 * np.pi * f0 * t[None, :, None])
    x = x + 2000.0 * rng.standard_normal((B, n * 480, C)) + 500.0
    return x.astype(np.float32).reshape(B, n, 480, C).transpose(1, 0, 2, 3)


@pytest.mark.parametrize("rate", [16000, 32000, 48000])
def test_hpf_k1_twin_matches_make_cascade(rate):
    """K1's plain twin through the HPF against the JAX cascade
    (make_cascade under vmap: its scan_impl oracle) over 10 frames from a
    non-zero state; the tolerance of the issue, rtol 1e-5 / atol 1e-3."""
    rng = np.random.default_rng(rate)
    jstate = j_hpf.init_state(C)
    jstate = jax.tree_util.tree_map(
        lambda a: jnp.asarray(
            rng.standard_normal((B,) + a.shape).astype(np.float32) * 300.0),
        jstate)
    state = hpf.HighPassFilterState(filt=biquad.BiquadCascadeState(
        x=_t(np.asarray(jstate.filt.x)), y=_t(np.asarray(jstate.filt.y))))
    module = hpf.HighPassFilter(rate)
    jstep = _vmap_jit(lambda s, x: j_hpf.process(s, x, rate))
    for frame in _hpf_frames(10, rate):
        jstate, want = jstep(jstate, frame)
        state, got = module(state, _t(frame))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-3)
    np.testing.assert_allclose(state.filt.y.numpy(),
                               np.asarray(jstate.filt.y), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(state.filt.x.numpy(),
                               np.asarray(jstate.filt.x), rtol=1e-5, atol=1e-3)
    assert cuda_biquad.launches == 0  # the CPU path never launches K1


@pytest.mark.parametrize("sections", [1, 2, 4])
def test_k1_twin_matches_make_cascade_other_sections(sections):
    """The twin's contracted rounding also holds for cascades with b0 != 1
    in every section (the AEC3 decimators and PostFilter share K1)."""
    rng = np.random.default_rng(sections)
    poles = rng.uniform(0.5, 0.95, sections)
    cb = np.stack([rng.uniform(0.2, 1.2, sections),
                   -rng.uniform(0.2, 1.5, sections),
                   rng.uniform(0.2, 1.2, sections)], 1).astype(np.float32)
    ca = np.stack([-2 * poles * 0.9, poles ** 2], 1).astype(np.float32)
    cascade = j_pb.make_cascade(cb, ca, channels=0)
    M, T = 6, 480
    st = rng.standard_normal((M, sections, 4)).astype(np.float32) * 100.0
    x = rng.standard_normal((M, T)).astype(np.float32) * 1000.0
    jst, jy = jax.jit(jax.vmap(cascade))(st, x)
    coeffs = _t(biquad.pack_coeffs(cb, ca))
    st_t = _t(st.transpose(1, 2, 0).reshape(4 * sections, M))
    st_new, y_t = cuda_biquad.cascade(coeffs, st_t, _t(x.T))
    np.testing.assert_allclose(y_t.numpy().T, np.asarray(jy), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(
        st_new.numpy().reshape(sections, 4, M).transpose(2, 0, 1),
        np.asarray(jst), rtol=1e-5, atol=1e-3)


def test_kernel_wrappers_reject_other_devices():
    # A CUDA tensor launches the kernel; only a CPU tensor takes the twin.
    # Any other device raises instead of falling back.
    meta = torch.empty((480, 4), device="meta")
    with pytest.raises(ValueError):
        cuda_biquad.cascade(torch.empty((3, 5), device="meta"),
                            torch.empty((12, 4), device="meta"), meta)
    with pytest.raises(ValueError):
        cuda_window.take_windows(torch.empty((2, 864), device="meta"),
                                 torch.empty((2,), device="meta"), 480)


def test_k1_checks_shapes():
    with pytest.raises(ValueError):
        cuda_biquad.cascade(torch.zeros(5, 5), torch.zeros(20, 4),
                            torch.zeros(480, 4))
    with pytest.raises(ValueError):
        cuda_biquad.cascade(torch.zeros(3, 5), torch.zeros(8, 4),
                            torch.zeros(480, 4))


# ------------------------------------------------------------- three band


def test_three_band_analysis_synthesis_match():
    """Tolerances of tests/test_three_band.py (vs its reference loop)."""
    rng = np.random.default_rng(11)
    jstate = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (B,) + a.shape), j_tb.init_state((C,)))
    state = three_band.init_state(B, C, "cpu")
    bank = three_band.ThreeBandFilterBank()
    ana = _vmap_jit(j_tb.analysis)
    syn = _vmap_jit(j_tb.synthesis)
    for _ in range(4):
        x = (rng.standard_normal((B, 480, C)) * 8000).astype(np.float32)
        jbands, jstate = ana(x, jstate)
        bands, state = bank.analysis(_t(x), state)
        np.testing.assert_allclose(bands.numpy(), np.asarray(jbands),
                                   rtol=1e-4, atol=3e-2)
        sb = (rng.standard_normal((B, 3, 160, C)) * 5000).astype(np.float32)
        jout, jstate = syn(sb, jstate)
        out, state = bank.synthesis(_t(sb), state)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-4,
                                   atol=6e-2)
    np.testing.assert_allclose(state.analysis.numpy(),
                               np.asarray(jstate.analysis), rtol=1e-4,
                               atol=3e-2)
    np.testing.assert_allclose(state.synthesis.numpy(),
                               np.asarray(jstate.synthesis), rtol=1e-4,
                               atol=6e-2)


@pytest.mark.parametrize("downmix", [False, True])
def test_audio_buffer_round_trip_matches(downmix):
    """copy_from -> split -> merge -> copy_to at 48 kHz, with the
    three-band tolerances."""
    out_ch = 1 if downmix else C
    jcfg = j_ab.BufferConfig(48000, C, 48000, out_ch, 48000, out_ch,
                             JDownmix.AVERAGE_CHANNELS)
    cfg = audio_buffer.BufferConfig(48000, C, 48000, out_ch, 48000, out_ch,
                                    DownmixMethod.AVERAGE_CHANNELS)
    module = audio_buffer.AudioBuffer(cfg)

    def jstep(st, x):
        st, y = j_ab.copy_from(jcfg, st, x)
        st, bands = j_ab.split_into_frequency_bands(jcfg, st, y)
        st, y2 = j_ab.merge_frequency_bands(jcfg, st, bands)
        st, out = j_ab.copy_to(jcfg, st, y2)
        return st, bands, out

    jstep = _vmap_jit(jstep)
    jst = jax.tree_util.tree_map(lambda a: jnp.broadcast_to(a, (B,) + a.shape),
                                 j_ab.init_state(jcfg))
    st = audio_buffer.init_state(cfg, B, "cpu")
    rng = np.random.default_rng(3)
    for _ in range(3):
        x = rng.uniform(-0.5, 0.5, (B, 480, C)).astype(np.float32)
        jst, jbands, jout = jstep(jst, x)
        st, y = module.copy_from(st, _t(x))
        st, bands = module.split_into_frequency_bands(st, y)
        st, y2 = module.merge_frequency_bands(st, bands)
        st, out = module.copy_to(st, y2)
        np.testing.assert_allclose(bands.numpy(), np.asarray(jbands),
                                   rtol=1e-4, atol=3e-2)
        np.testing.assert_allclose(out.numpy() * 32768.0,
                                   np.asarray(jout) * 32768.0, rtol=1e-4,
                                   atol=6e-2)


def test_rms_level_matches():
    rng = np.random.default_rng(4)
    jst = jax.tree_util.tree_map(lambda a: jnp.broadcast_to(a, (B,) + a.shape),
                                 j_rms.init_state())
    st = rms_level.init_state(B, "cpu")
    step = _vmap_jit(j_rms.analyze)
    for _ in range(3):
        x = (rng.standard_normal((B, 480, C)) * 9000).astype(np.float32)
        jst = step(jst, x)
        st = rms_level.analyze(st, _t(x))
    np.testing.assert_allclose(st.sum_square.numpy(),
                               np.asarray(jst.sum_square), rtol=1e-6)
    np.testing.assert_array_equal(st.sample_count.numpy(),
                                  np.asarray(jst.sample_count))
    np.testing.assert_allclose(st.max_sum_square.numpy(),
                               np.asarray(jst.max_sum_square), rtol=1e-6)


# ------------------------------------------------------------- resampler, FFTs


def test_resampler_plan_is_identical():
    for s, d in ((480, 240), (320, 160), (160, 480)):
        j_idx, j_k = j_rs.make_plan(s, d)
        idx, k = resampler.make_plan(s, d)
        np.testing.assert_array_equal(idx, j_idx)
        np.testing.assert_array_equal(k, j_k)


def test_resampler_48k_to_24k_matches():
    """Tolerance of tests/test_resampler.py:72."""
    rng = np.random.default_rng(5)
    module = resampler.PushSincResampler(480, 240)
    jst = jnp.zeros((B, 2 * 480 + 32), jnp.float32)
    st = resampler.init_state(480, B, "cpu")
    step = _vmap_jit(lambda s, x: j_rs.resample_frame(s, x, 480, 240))
    for _ in range(4):
        x = (rng.standard_normal((B, 480)) * 1000).astype(np.float32)
        jst, want = step(jst, x)
        st, got = module(st, _t(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=0.5)
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst))


def test_ffts_match():
    rng = np.random.default_rng(6)
    x480 = rng.standard_normal((B, 480)).astype(np.float32) * 100
    want = np.asarray(jax.jit(j_mixed.rfft480)(x480))
    got = mixed_fft.rfft480(_t(x480)).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    x256 = rng.standard_normal((B, 256)).astype(np.float32) * 100
    spec = mxu_fft.rfft(_t(x256), 256)
    np.testing.assert_allclose(spec.numpy(), np.fft.rfft(x256),
                               rtol=0, atol=1e-5 * np.abs(spec.numpy()).max())
    np.testing.assert_allclose(mxu_fft.irfft(spec, 256).numpy(), x256,
                               rtol=0, atol=1e-4)
