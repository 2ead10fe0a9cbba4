"""The AEC3 delay stack of the port against the JAX package on the CPU: the
twins of K3 (the matched-filter NLMS bank) and K4 (the pre-echo errors)
against the JAX kernels' CPU oracles, and the delay phase of the block
pipeline (render inserts, buffer events, matched filter, lag aggregation,
alignment) on a delayed-echo scene."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from webrtc_audio_processing_tpu.models.aec3 import (
    echo_canceller3 as j_ec3,
    render_buffer as j_rb,
)
from webrtc_audio_processing_tpu.ops import pallas_mf, pallas_pre_echo

from webrtc_audio_processing_tpu_torch.models.aec3 import (
    echo_canceller3 as ec3,
    render_buffer as rb,
)
from webrtc_audio_processing_tpu_torch.ops import (
    cuda_matched_filter,
    cuda_pre_echo,
)

from tests.torch_aec3_setup import (
    assert_states_close,
    batched,
    flat,
    ordinal,
    geometries,
    t,
    torch_tree,
)

B = 3
F32 = np.float32


def _max_rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / (np.abs(want).max() + 1e-30))


@pytest.mark.parametrize("saturated", [False, True])
def test_k3_twin_matches_nlms_scan(saturated):
    """K3's twin against the jitted JAX oracle ``pallas_mf._nlms_scan``
    (XLA:CPU contracts its multiply-adds): max-relative 2e-5 on h, alphas
    and err, ``updated`` and ``segs`` exact (tests/test_pallas_mf_kernel.py's
    bar)."""
    rng = np.random.default_rng(5 + saturated)
    low = rng.standard_normal((B, 2448)).astype(F32) * 400
    lr = rng.integers(0, 2448, B).astype(np.int32)
    h0 = rng.standard_normal((B, 5, 512)).astype(F32) * 0.01
    y = rng.standard_normal((B, 16)).astype(F32) * 400
    if saturated:
        y[:, 3] = 32001.0
    low[2] *= 0.01  # one stream under the excitation threshold
    sm = np.full((B,), 0.7, F32)
    thr = 512 * 150.0 ** 2
    want = jax.jit(jax.vmap(functools.partial(
        pallas_mf._nlms_scan, n_filters=5, shift=384, ds_size=2448,
        threshold=thr)))(low, lr, h0, y, sm)
    got = cuda_matched_filter.nlms(t(low), t(lr), t(h0), t(y), t(sm),
                                   shift=384, ds_size=2448, threshold=thr)
    for name, g, w in zip(("h", "alphas", "err"), got[:3], want[:3]):
        assert _max_rel(g.numpy(), w) <= 2e-5, name
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))


def test_k4_twin_matches_pre_echo_inst_xla():
    """K4's twin against the jitted ``pre_echo_inst_xla``, within 2e-4
    after dividing by max(|out|, 1) (tests/test_pallas_pre_echo.py)."""
    rng = np.random.default_rng(9)
    seg = rng.standard_normal((B, 527)).astype(F32) * 100
    h0 = (rng.standard_normal((B, 512)) * 0.1).astype(F32)
    al = (rng.standard_normal((B, 16)) * 1e-4).astype(F32)
    y = rng.standard_normal((B, 16)).astype(F32) * 100
    want = np.asarray(jax.jit(jax.vmap(functools.partial(
        pallas_pre_echo.pre_echo_inst_xla, sub=16, taps=512, acc_rate=4)))(
        seg, h0, al, y))
    got = cuda_pre_echo.pre_echo_inst(t(seg), t(h0), t(al), t(y), 4).numpy()
    scale = np.maximum(np.abs(want), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=2e-4)


@functools.lru_cache(maxsize=None)
def _j_fns():
    jgeo = geometries()[0].aec3
    cfg = jgeo.config
    inserts = [jax.jit(jax.vmap(
        lambda s, blk, n, k=k: j_rb.insert(jgeo.buffer, cfg, s, blk, n,
                                           sf_slot=k), in_axes=(0, 0, None)))
        for k in range(5)]
    flush = jax.jit(jax.vmap(
        lambda s, n: j_rb.flush_sf_pending(jgeo.buffer, s, n),
        in_axes=(0, None)))
    phase = jax.jit(jax.vmap(
        lambda s, blk, n: j_ec3._delay_phase_block(jgeo, s, blk, n),
        in_axes=(0, 0, None)))
    return inserts, flush, phase


def test_delay_phase_matches_jax_on_a_delayed_echo():
    """40 frames (100 blocks) of the paired cadence: white render, capture
    the render delayed by 20, 90 and 170 samples at the 16 kHz band rate
    per stream plus noise. The estimated delay and its validity, the
    delay-change flags and the ring read distances equal on every block;
    the state after the last block leaf by leaf: integer and boolean
    leaves exact, float leaves within 2e-5 of each leaf's scale (the NLMS
    tolerance; the FFT rows of the rings within float rounding)."""
    jgeo_apm, geo_apm = geometries()
    jgeo, geo = jgeo_apm.aec3, geo_apm.aec3
    inserts, flush, phase = _j_fns()
    rng = np.random.default_rng(21)
    delays = (64, 128, 200)
    n_frames = 40
    far = rng.standard_normal((B, n_frames * 160 + 200)).astype(F32) * 2000
    js = batched(j_ec3.init_state(jgeo), B)
    state = torch_tree(ec3.init_state(geo, B, "cpu"), js)
    for f in range(n_frames):
        parity, n0 = f % 2, 5 * (f // 2) + 2 * (f % 2)
        seg = slice(200 + f * 160, 200 + (f + 1) * 160)
        render = np.zeros((B, 3, 160, 2), F32)
        render[:, 0, :, 0] = far[:, seg]
        render[:, 0, :, 1] = far[:, seg]
        capture = np.zeros((B, 3, 160, 2), F32)
        for b, d in enumerate(delays):
            echo = far[b, 200 + f * 160 - d: 200 + (f + 1) * 160 - d]
            capture[b, 0, :, 0] = 0.5 * echo
            capture[b, 0, :, 1] = 0.4 * echo
        capture[:, 0] += rng.standard_normal((B, 160, 2)).astype(F32) * 30
        # Render: flush at even frames, then the frame's staged inserts.
        jbuf, buf = js.buffer, state.buffer
        if parity == 0:
            jbuf = flush(jbuf, jnp.int32(n0))
            buf = rb.flush_sf_pending(geo.buffer, buf, ordinal(n0))
        # The frame blocker only slices: both packages take its blocks.
        blocks, carry = ec3._split_blocks(t(render),
                                          state.render_blocker_carry, parity)
        base = 0 if parity == 0 else 2
        for k, blk in enumerate(blocks):
            jbuf, _ = inserts[base + k](jbuf, blk.numpy(),
                                        jnp.int32(n0 + k + 1))
            buf, _ = rb.insert(geo.buffer, geo.config, buf, blk,
                               ordinal(n0 + k + 1), sf_slot=base + k)
        js = js.replace(buffer=jbuf)
        state = state.replace(buffer=buf, render_blocker_carry=carry)
        n = n0 + len(blocks)
        cblocks, ccarry = ec3._split_blocks(t(capture),
                                            state.capture_blocker_carry,
                                            parity)
        for blk in cblocks:
            js, jdch, jdl, jvl = phase(js, blk.numpy(), jnp.int32(n))
            state, dch, dl, vl = ec3._delay_phase_block(geo, state, blk,
                                                        ordinal(n))
            np.testing.assert_array_equal(dl.numpy(), np.asarray(jdl))
            np.testing.assert_array_equal(vl.numpy(), np.asarray(jvl))
            np.testing.assert_array_equal(dch.numpy(), np.asarray(jdch))
            np.testing.assert_array_equal(state.buffer.b_delay.numpy(),
                                          np.asarray(js.buffer.b_delay))
        state = state.replace(capture_blocker_carry=ccarry)
    # Every stream found its echo: with pre-echo detection the estimate is
    # the echo delay less the 32-sample headroom, in whole 64-sample blocks.
    assert state.delay.delay_valid.all()
    np.testing.assert_array_equal(state.delay.delay_samples.numpy(),
                                  [(d - 32) // 64 * 64 for d in delays])
    want = {k: v for k, v in flat(js).items()
            if k.startswith(("buffer", "delay"))}
    got = {k: v for k, v in _flat_state(state).items() if k in want}
    assert_states_close(got, want, rtol=2e-5)


def _flat_state(state):
    from webrtc_audio_processing_tpu_torch import apm
    return apm.state_to_numpy(state)
