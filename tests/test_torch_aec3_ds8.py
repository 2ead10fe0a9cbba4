"""AEC3 with down-sampling by 8 (``delay.down_sampling_factor=8``) against
the JAX package on the CPU: the geometry; the render and capture
decimators (five band-pass sections and no high-pass, one K1 launch of
K = 5) bit for bit; the render buffer's inserts, staged flushes and span
reads; ``echo_canceller3.process_frame`` at 16 kHz mono, B = 2 streams of
a mono echo scene, 30 ms late, for 40 frames, in floatS16: the outputs
within the BASELINE.md bar, the delay estimator's delay equal on every
frame (it locks at frame 29), and the whole AEC3 state (render buffer,
delay estimator with K3's and K4's general forms at taps 256, sub 8) a
few frames in. The JAX steps, one
stream each, compile side by side, once, in the module fixture."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from webrtc_audio_processing_tpu.models.aec3 import (
    config as j_a3cfg,
    delay_estimator as j_de,
    echo_canceller3 as j_ec3,
    render_buffer as j_rb,
)

from webrtc_audio_processing_tpu_torch import apm
from webrtc_audio_processing_tpu_torch.models.aec3 import (
    config as a3cfg,
    delay_estimator as de,
    echo_canceller3 as ec3,
    render_buffer as rb,
)

from tests.torch_aec3_setup import (
    assert_states_close,
    batched,
    flat,
    mono_scene,
    ordinal,
    rel_rms_per_stream,
    run_aec3_both,
    t,
    torch_tree,
)

B = 2
RATE = 16000
N_FRAMES = 40
STATE_FRAMES = (2, 5)  # the states are compared after these frames
ECHO_DELAY = 480  # samples: the delay estimator locks at frame 29


def _config(m):
    cfg, _ = m.validate(m.EchoCanceller3Config())
    return cfg.replace(delay=dataclasses.replace(cfg.delay,
                                                 down_sampling_factor=8))


@functools.lru_cache(maxsize=None)
def _geometries():
    return (j_ec3.Aec3Geometry.create(_config(j_a3cfg), RATE, 1, 1),
            ec3.Aec3Geometry.create(_config(a3cfg), RATE, 1, 1))


@pytest.fixture(scope="module")
def runs():
    jgeo, geo = _geometries()
    renders, captures = mono_scene(N_FRAMES, B, seed=5, delay=ECHO_DELAY)
    return run_aec3_both(jgeo, geo, renders, captures, STATE_FRAMES)


def test_geometry_at_factor_8():
    """The render buffer's and the delay estimator's geometries equal the
    JAX package's: sub-blocks of 8, 256 taps, the low-rate ring and the
    histograms sized for factor 8; the decimators keep five band-pass
    sections and no high-pass; config validation resets any factor but 4
    and 8 to 4, as JAX's."""
    jgeo, geo = _geometries()
    assert dataclasses.asdict(geo.buffer) == dataclasses.asdict(jgeo.buffer)
    assert dataclasses.asdict(geo.delay) == dataclasses.asdict(jgeo.delay)
    assert (geo.delay.sub_block_size, geo.delay.filter_length) == (8, 256)
    assert rb.decimator_sections(8) == (5, 0)
    assert rb.decimator_sections(4) == (3, 1)
    state = ec3.init_state(geo, B, "cpu")
    for st in (state.buffer.decimator_aa, state.delay.capture_decimator_aa):
        assert tuple(st.x.shape) == (B, 5, 2)
    for st in (state.buffer.decimator_nr, state.delay.capture_decimator_nr):
        assert tuple(st.y.shape) == (B, 0, 2)
    for factor, want in ((8, 8), (3, 4)):
        def cfg(m):
            c = m.EchoCanceller3Config()
            return m.validate(c.replace(delay=dataclasses.replace(
                c.delay, down_sampling_factor=factor)))[0]
        assert cfg(a3cfg).delay.down_sampling_factor == want
        assert cfg(j_a3cfg).delay.down_sampling_factor == want


@pytest.mark.parametrize("side", ["render", "capture"])
def test_decimators_match_jax_bit_for_bit(side):
    """Eight blocks through the render buffer's and the delay estimator's
    decimators (JAX's ``_decimate`` and ``_decimate_capture``, the scan
    XLA:CPU contracts into fused multiply-adds) and the port's
    ``render_buffer.decimate`` (one K1 launch of 5 sections): outputs and
    both cascades' states bit for bit."""
    jgeo, geo = _geometries()
    cfg = geo.config
    rng = np.random.default_rng(8 if side == "render" else 9)
    if side == "render":
        js = batched(j_rb.init_state(jgeo.buffer, jgeo.config), B)
        jstep = jax.jit(jax.vmap(lambda s, v: j_rb._decimate(
            jgeo.buffer, s, v)))
        st = rb.init_state(geo.buffer, cfg, B, "cpu")
        aa, nr = st.decimator_aa, st.decimator_nr
        names = ("decimator_aa", "decimator_nr")
    else:
        js = batched(j_de.init_state(jgeo.delay, jgeo.config, 1), B)
        jstep = jax.jit(jax.vmap(lambda s, v: j_de._decimate_capture(
            jgeo.delay, s, v)))
        st = de.init_state(geo.delay, cfg, 1, B, "cpu")
        aa, nr = st.capture_decimator_aa, st.capture_decimator_nr
        names = ("capture_decimator_aa", "capture_decimator_nr")
    for _ in range(8):
        x = (rng.standard_normal((B, 64)) * 3000).astype(np.float32)
        js, jy = jstep(js, x)
        aa, nr, y = rb.decimate(8, aa, nr, t(x))
        assert tuple(y.shape) == (B, 8)
        np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    for name, got in zip(names, (aa, nr)):
        want = getattr(js, name)
        np.testing.assert_array_equal(got.x.numpy(), np.asarray(want.x))
        np.testing.assert_array_equal(got.y.numpy(), np.asarray(want.y))


def test_render_buffer_insert_flush_and_reads_match_jax():
    """Six frames of the paired cadence at factor 8 (flush at each even
    frame, then 2 or 3 staged inserts) from a JAX state in mid-stream:
    the rings, staging, the low-rate ring (sub-blocks of 8) and the
    decimator state bit for bit, the FFT rows within 1e-6 of each row's
    scale (jnp.fft and torch.fft round differently by ~1 ulp); then every
    span read of both packages on one state, bit for bit."""
    jgeo, geo = _geometries()
    jcfg, cfg = jgeo.config, geo.config
    rng = np.random.default_rng(12)
    js = batched(j_rb.init_state(jgeo.buffer, jcfg), B)
    js = js.replace(
        sf=rng.standard_normal(js.sf.shape).astype(np.float32),
        blocks=rng.standard_normal(js.blocks.shape).astype(np.float32),
        lowrate=rng.standard_normal(js.lowrate.shape).astype(np.float32),
        b_delay=rng.integers(1, 40, B).astype(np.int32),
        lr_latency=(8 * rng.integers(1, 40, B)).astype(np.int32))
    template = rb.init_state(geo.buffer, cfg, B, "cpu")
    state = torch_tree(template, js)
    insert = {slot: jax.jit(jax.vmap(
        lambda s, blk, n, slot=slot: j_rb.insert(
            jgeo.buffer, jcfg, s, blk, n, sf_slot=slot),
        in_axes=(0, 0, None))) for slot in range(5)}
    flush = jax.jit(jax.vmap(lambda s, n: j_rb.flush_sf_pending(
        jgeo.buffer, s, n), in_axes=(0, None)))
    f0 = 41
    for f in range(f0, f0 + 6):
        parity, n0 = f % 2, 5 * (f // 2) + 2 * (f % 2)
        if parity == 0:
            js = flush(js, jnp.int32(n0))
            state = rb.flush_sf_pending(geo.buffer, state, ordinal(n0))
        base = 0 if parity == 0 else 2
        for k in range(2 + parity):
            blk = (rng.standard_normal((B, 1, 64, 1)) * 3000).astype(
                np.float32)
            js, jev = insert[base + k](js, blk, jnp.int32(n0 + k + 1))
            state, ev = rb.insert(geo.buffer, cfg, state, t(blk),
                                  ordinal(n0 + k + 1), sf_slot=base + k)
            np.testing.assert_array_equal(ev.numpy(), np.asarray(jev))
    want = flat(js)
    got = apm.state_to_numpy(state)
    fft_rows = ("sf", "sf_pending")
    assert_states_close({k: v for k, v in got.items() if k not in fft_rows},
                        {k: v for k, v in want.items() if k not in fft_rows},
                        rtol=0.0)
    for k in fft_rows:
        scale = np.abs(want[k]).max(axis=-1, keepdims=True) + 1e-30
        assert (np.abs(got[k] - want[k]) / scale).max() <= 1e-6, k

    state = torch_tree(template, js)
    n = 5 * ((f0 + 6) // 2)
    for pending in (0, 2, 5):
        view = rb.RenderView(state, ordinal(n), pending)
        starts = rng.integers(0, geo.buffer.num_blocks, B).astype(np.int32)
        for read, jread, W in ((rb.sf_span, j_rb.sf_span, 17),
                               (rb.blocks_span, j_rb.blocks_span, 13)):
            want_rows = jax.vmap(lambda st, s, r=jread, w=W: r(
                jgeo.buffer, j_rb.RenderView(st, jnp.int32(n), pending), s,
                w))(js, starts)
            np.testing.assert_array_equal(
                read(geo.buffer, view, t(starts), W).numpy(),
                np.asarray(want_rows))


def test_output_matches_jax_within_relative_rms(runs):
    """40 frames: relative RMS <= 1e-3 per stream (the BASELINE.md bar),
    finite."""
    got, want = runs["torch"], runs["jax"]
    assert got.shape == want.shape == (N_FRAMES, B, 1, 160, 1)
    assert np.isfinite(got).all()
    rel = rel_rms_per_stream(got, want)
    assert (rel <= 1e-3).all(), rel


def test_delay_equal_on_every_frame(runs):
    """The delay estimator's delay in samples, a multiple of 8, equal on
    every frame; it has locked on the echo's 480 samples (to 448, a whole
    number of blocks below) by the last frame."""
    np.testing.assert_array_equal(runs["torch_delay"], runs["jax_delay"])
    assert (runs["torch_delay"] % 8 == 0).all()
    assert (runs["torch_delay"][-1] == 448).all()


@pytest.mark.parametrize("frame", STATE_FRAMES)
def test_state_matches_jax_a_few_frames_in(runs, frame):
    """Every leaf of AEC3's state, the render buffer and the delay
    estimator at factor 8 included: integer and boolean leaves exact, float
    leaves within 1e-4 of each leaf's scale
    (tests/test_torch_apm_16k_mono.py's bar)."""
    got, want = runs["torch_state"][frame], runs["jax_state"][frame]
    assert_states_close(got, want, rtol=1e-4)
    assert got["delay.matched_filter.filters"].shape[-1] == 256
