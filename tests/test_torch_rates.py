"""The modules the APM's rate matrix adds to the port, against the JAX
package on the CPU: the two-band QMF on K1's twin, the two-band splitting
filter, the AudioBuffer's resampling in and out (the output resampler cut
to the live channels after the mono narrowing), AEC3's mono render downmix
and the split-band HPF. Inputs are made from seeds with numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webrtc_audio_processing_tpu import apm as j_apm
from webrtc_audio_processing_tpu import config as j_cfg
from webrtc_audio_processing_tpu.models import audio_buffer as j_ab
from webrtc_audio_processing_tpu.models.aec3 import config as j_a3cfg
from webrtc_audio_processing_tpu.models.aec3 import (
    echo_canceller3 as j_ec3,
)
from webrtc_audio_processing_tpu.ops import qmf as j_qmf
from webrtc_audio_processing_tpu.ops import splitting as j_split

from webrtc_audio_processing_tpu_torch import apm
from webrtc_audio_processing_tpu_torch import config as cfg_mod
from webrtc_audio_processing_tpu_torch.models import audio_buffer
from webrtc_audio_processing_tpu_torch.models.aec3 import (
    config as a3cfg,
    echo_canceller3 as ec3,
)
from webrtc_audio_processing_tpu_torch.ops import cuda_biquad, qmf, splitting

from tests.torch_aec3_setup import (
    assert_states_close,
    batched,
    flat,
    ordinal,
    t,
    torch_tree,
)

B, C = 2, 2
FRAMES = 3
# JAX's own bar for its QMF against the reference C loop, in floatS16
# (tests/test_ops_foundation.py:113-139).
QMF_RTOL, QMF_ATOL = 1e-4, 2e-2


def _lanes(x):
    """(B, N, C) -> (N, B, C): the JAX functions take time first and the
    streams and channels as trailing batch axes."""
    return np.ascontiguousarray(np.moveaxis(x, 1, 0))


def _qmf_state(st):
    """A JAX (3, 2, B, C) QmfState -> the port's (B, 3, 2, C)."""
    return qmf.QmfState(
        *(torch.from_numpy(np.ascontiguousarray(np.moveaxis(
            np.asarray(s), (2, 3), (0, 3)))) for s in (st.state1, st.state2)))


def _assert_qmf_close(got, want, what):
    err = float(np.abs(got - want).max())
    np.testing.assert_allclose(
        got, want, rtol=QMF_RTOL, atol=QMF_ATOL,
        err_msg=f"{what}: max |port - JAX| {err} floatS16")


def test_qmf_analysis_and_synthesis_match_jax():
    """Three frames with the state carried, B = 2 streams x 2 channels of
    noise at 8000 floatS16 (analysis) and bands at 5000 / 2000
    (synthesis): within JAX's bar of rtol 1e-4, atol 2e-2 floatS16. The
    largest difference measured is 0 (K1's all-pass form evaluates JAX's
    order); K1's general order gave 0.0049 (low band), 0.0044 (high
    band) and 0.0039 (synthesis) floatS16."""
    rng = np.random.default_rng(11)
    bank = qmf.Qmf()
    a_st, s_st = qmf.init_state(B, C, "cpu"), qmf.init_state(B, C, "cpu")
    ja, js = j_qmf.init_state((B, C)), j_qmf.init_state((B, C))
    j_analysis, j_synthesis = jax.jit(j_qmf.analysis), jax.jit(
        j_qmf.synthesis)
    for _ in range(FRAMES):
        x = (rng.standard_normal((B, 320, C)) * 8000).astype(np.float32)
        bands, a_st = bank.analysis(torch.from_numpy(x), a_st)
        (jlow, jhigh), ja = j_analysis(jnp.asarray(_lanes(x)), ja)
        _assert_qmf_close(bands[:, 0].numpy(),
                          np.moveaxis(np.asarray(jlow), 0, 1), "low band")
        _assert_qmf_close(bands[:, 1].numpy(),
                          np.moveaxis(np.asarray(jhigh), 0, 1), "high band")
        low = (rng.standard_normal((B, 160, C)) * 5000).astype(np.float32)
        high = (rng.standard_normal((B, 160, C)) * 2000).astype(np.float32)
        out, s_st = bank.synthesis(
            torch.from_numpy(np.stack([low, high], axis=1)), s_st)
        jout, js = j_synthesis(jnp.asarray(_lanes(low)),
                               jnp.asarray(_lanes(high)), js)
        _assert_qmf_close(out.numpy(), np.moveaxis(np.asarray(jout), 0, 1),
                          "synthesis")
    for got, want in ((a_st, _qmf_state(ja)), (s_st, _qmf_state(js))):
        _assert_qmf_close(got.state1.numpy(), want.state1.numpy(), "state1")
        _assert_qmf_close(got.state2.numpy(), want.state2.numpy(), "state2")


def test_qmf_runs_each_branch_as_one_k1_cascade(monkeypatch):
    """Analysis and synthesis each call K1's wrapper twice, in its all-pass
    form with the three rows [a, 1, 0, a, 0] over all B x C lanes at
    once."""
    calls = []
    cascade = cuda_biquad.cascade

    def spy(coeffs, state, x_t, allpass=False):
        calls.append((coeffs.numpy().copy(), tuple(state.shape),
                      tuple(x_t.shape), allpass))
        return cascade(coeffs, state, x_t, allpass)

    monkeypatch.setattr(cuda_biquad, "cascade", spy)
    bank = qmf.Qmf()
    bands, _ = bank.analysis(torch.zeros(B, 320, C),
                             qmf.init_state(B, C, "cpu"))
    bank.synthesis(bands, qmf.init_state(B, C, "cpu"))
    assert [c[1:] for c in calls] == [((12, B * C), (160, B * C),
                                       True)] * 4
    rows = {tuple(c[0][:, 0]) for c in calls}
    assert rows == {tuple(np.float32(qmf.ALLPASS_COEF_1)),
                    tuple(np.float32(qmf.ALLPASS_COEF_2))}
    for c in calls:
        np.testing.assert_array_equal(c[0][:, 1:], np.stack(
            [np.ones(3), np.zeros(3), c[0][:, 0], np.zeros(3)], 1))


def test_two_band_splitting_round_trip_matches_jax():
    """The SplittingFilter's two-band branch: split then merge of three
    frames, against JAX's ``splitting`` with both directions' states."""
    rng = np.random.default_rng(12)
    filt = splitting.SplittingFilter(2)
    st = splitting.init_state(2, B, C, "cpu")
    jst = j_split.init_state(2, (B, C))

    @jax.jit
    def jround(s, x):
        bands, s = j_split.analysis(x, s, 2)
        out, s = j_split.synthesis(bands, s, 2)
        return bands, out, s

    for _ in range(FRAMES):
        x = (rng.standard_normal((B, 320, C)) * 3000).astype(np.float32)
        bands, st = filt.analysis(torch.from_numpy(x), st)
        out, st = filt.synthesis(bands, st)
        jbands, jout, jst = jround(jst, jnp.asarray(_lanes(x)))
        _assert_qmf_close(bands.numpy(), np.moveaxis(np.asarray(jbands),
                                                     (1, 2), (2, 0)),
                          "bands")
        _assert_qmf_close(out.numpy(), np.moveaxis(np.asarray(jout), 0, 1),
                          "merged")
    for got, want in ((st.analysis, jst.analysis),
                      (st.synthesis, jst.synthesis)):
        want = _qmf_state(want)
        _assert_qmf_close(got.state1.numpy(), want.state1.numpy(), "state1")
        _assert_qmf_close(got.state2.numpy(), want.state2.numpy(), "state2")


def _buffer_configs(m, in_rate, buf_rate, out_rate, in_ch, buf_ch, out_ch):
    return m.BufferConfig(input_rate=in_rate, input_num_channels=in_ch,
                          buffer_rate=buf_rate, buffer_num_channels=buf_ch,
                          output_rate=out_rate, output_num_channels=out_ch)


# (input rate, buffer rate, output rate, input / buffer / output channels,
# live channels at copy_to): 48 -> 32 -> 48 kHz and 8 -> 16 -> 8 kHz as
# the APM's matrix gives them, the reverse pairs, the stereo render
# downmixed into a mono buffer, and the stereo capture narrowed to mono
# after the split (the sliced output resampler).
BUFFER_CASES = {
    "48_32_48": (48000, 32000, 48000, 2, 2, 2, 2),
    "32_48_32": (32000, 48000, 32000, 2, 2, 2, 2),
    "8_16_8": (8000, 16000, 8000, 1, 1, 1, 1),
    "16_8_16": (16000, 8000, 16000, 1, 1, 1, 1),
    "48_32_48_downmix": (48000, 32000, 48000, 2, 1, 2, 1),
    "48_32_48_narrowed": (48000, 32000, 48000, 2, 2, 2, 1),
}


@pytest.mark.parametrize("case", sorted(BUFFER_CASES))
def test_audio_buffer_resampling_matches_jax(case):
    """copy_from and copy_to over three frames against JAX's
    ``audio_buffer`` (tests/test_audio_buffer.py:55-95), B = 2: both
    frames and both resampler states bit for bit (the port sums each
    output's 32 taps in XLA:CPU's order). In the narrowed case only
    channel 0 passes the output resampler and channel 1's state stays
    zero."""
    in_rate, buf_rate, out_rate, in_ch, buf_ch, out_ch, live = (
        BUFFER_CASES[case])
    cfg = _buffer_configs(audio_buffer, in_rate, buf_rate, out_rate, in_ch,
                          buf_ch, out_ch)
    jcfg = _buffer_configs(j_ab, in_rate, buf_rate, out_rate, in_ch, buf_ch,
                           out_ch)
    buf = audio_buffer.AudioBuffer(cfg)
    st = audio_buffer.init_state(cfg, B, "cpu")
    jst = batched(j_ab.init_state(jcfg), B)

    @jax.jit
    @jax.vmap
    def jstep(s, x, y):
        s, got = j_ab.copy_from(jcfg, s, x)
        s, out = j_ab.copy_to(jcfg, s, y)
        return s, got, out

    rng = np.random.default_rng(13)
    for _ in range(FRAMES):
        x = rng.uniform(-0.8, 0.8, (B, in_rate // 100, in_ch)).astype(
            np.float32)
        y = (rng.standard_normal((B, buf_rate // 100, live)) * 6000).astype(
            np.float32)
        st, got = buf.copy_from(st, torch.from_numpy(x))
        st, out = buf.copy_to(st, torch.from_numpy(y))
        jst, jgot, jout = jstep(jst, x, y)
        assert got.shape == (B, buf_rate // 100, buf_ch)
        assert out.shape == (B, out_rate // 100, out_ch)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    for name in ("input_resampler", "output_resampler"):
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      np.asarray(getattr(jst, name)),
                                      err_msg=name)
    if live < buf_ch:
        assert not st.output_resampler[..., live:].any()


def _downmix_geometries():
    """AEC3 at 16 kHz with one capture channel, mono (no stereo content
    detected yet) on a two-channel render, in both packages."""
    jgeo = j_ec3.Aec3Geometry.create(j_a3cfg.EchoCanceller3Config(), 16000,
                                     1, 1)
    geo = ec3.Aec3Geometry.create(a3cfg.EchoCanceller3Config(), 16000, 1, 1)
    return jgeo, geo


def test_aec3_render_downmix_matches_jax_for_both_detector_states():
    """A stereo render into mono AEC3, one (even) frame: stream 0's
    channels are equal (no temporary stereo content: channel 0 is taken),
    stream 1's differ (temporary content: the channel mean). Output,
    linear output and every state leaf (the render rings hold the
    downmix) against JAX's ``process_frame``; the one JAX compile of the
    frame takes ~30 s."""
    jgeo, geo = _downmix_geometries()
    rng = np.random.default_rng(14)
    far = (rng.standard_normal((B, 1, 160, 1)) * 3000).astype(np.float32)
    render = np.concatenate([far, far], axis=-1)
    render[1, ..., 1] = (rng.standard_normal((1, 160)) * 3000).astype(
        np.float32)
    capture = (0.5 * far + (rng.standard_normal(far.shape) * 30)).astype(
        np.float32)
    jst = batched(j_ec3.init_state(jgeo), B)
    state = torch_tree(ec3.init_state(geo, B, "cpu"), jst)
    step = jax.jit(jax.vmap(lambda s, r, c, n0: j_ec3.process_frame(
        jgeo, s, r, c, 0, n0=n0), in_axes=(0, 0, 0, None)))
    jst, jout, jlin = step(jst, render, capture, jnp.int32(0))
    state, out, lin = ec3.process_frame(geo, state, t(render), t(capture), 0,
                                        ordinal(0))
    assert state.mc_detector.temporary_detected.tolist() == [False, True]
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                               atol=1e-2)
    np.testing.assert_allclose(lin.numpy(), np.asarray(jlin), rtol=0,
                               atol=1e-2)
    assert_states_close(apm.state_to_numpy(state), flat(jst), rtol=1e-5)
    # The blocker took the downmix: its carry holds the frame's last 32
    # samples, channel 0 of stream 0 and the channel mean of stream 1.
    want = np.stack([render[0, 0, 128:, 0], render[1, 0, 128:].mean(-1)])
    np.testing.assert_array_equal(
        state.render_blocker_carry[:, 0, :, 0].numpy(), want)


def _hpf_config(m):
    return m.Config().replace(high_pass_filter=m.HighPassFilter(
        enabled=True, apply_in_full_band=False))


@pytest.mark.parametrize("rate,channels", [(32000, 1), (48000, 2)])
def test_split_band_hpf_matches_jax(rate, channels):
    """HPF alone with ``apply_in_full_band`` false: band 0 is filtered with
    the 16 kHz table after the split (processing at 32 kHz, so 48 kHz
    passes the resamplers too). Four frames against JAX's
    ``process_stream_pair``, output and HPF state bit for bit: the
    resampler sums its taps in XLA:CPU's order, and K1's twin evaluates
    the QMF's all-pass rows and the HPF's biquads in the orders XLA:CPU
    contracts them to. (The HPF's poles lie within 0.0023 of the unit
    circle: with K1's general order on the all-pass rows, 0.005 floatS16
    of QMF rounding came out of it as 0.1-0.25, a relative RMS of up to
    1.2e-4.)"""
    jgeo = j_apm.ApmGeometry.create(_hpf_config(j_cfg), rate, channels)
    geo = apm.ApmGeometry.create(_hpf_config(cfg_mod), rate, channels)
    assert geo.capture_processing_rate == 32000 and geo.hpf_rate == 16000
    assert apm.module_for(geo, torch.device("cpu")).hpf.sample_rate_hz == (
        16000)
    jst = batched(j_apm.init_state(jgeo), B)
    state = apm.state_from_jax(jst, geo)
    step = jax.jit(jax.vmap(lambda s, c: j_apm.process_stream_pair(
        jgeo, s, c)[:2]))
    rng = np.random.default_rng(15)
    frame = rate // 100
    n = 4 * frame
    tt = np.arange(n) / rate
    for f in range(4):
        # A 50 Hz hum under a 6 kHz tone: the HPF takes the hum out of
        # band 0; the tone lies in band 1, which the HPF leaves alone.
        sl = slice(f * frame, (f + 1) * frame)
        x = (0.3 * np.sin(2 * np.pi * 50 * tt[sl]) + 0.1 * np.sin(
            2 * np.pi * 6000 * tt[sl]))[None, :, None] + 0.01 * (
            rng.standard_normal((B, frame, channels)))
        x = x.astype(np.float32)
        jst, jout = step(jst, x)
        state, out, _, _ = apm.process_stream_pair(geo, state,
                                                   torch.from_numpy(x))
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    got = apm.state_to_numpy(state)
    want = flat(jst)
    assert got["hpf.filt.x"].shape == (B, 3, 2, channels)
    for k in ("hpf.filt.x", "hpf.filt.y"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
