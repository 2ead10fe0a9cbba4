"""The AEC3 render side of the port against the JAX package on the CPU: the
AEC3 config tree, the render delay buffer (insert, staged flush, span
reads), K2's and K1's twins on their new shapes, the multichannel content
detector and the residual echo detector."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webrtc_audio_processing_tpu.models import echo_detector as j_ed
from webrtc_audio_processing_tpu.models import post_filter as j_pf
from webrtc_audio_processing_tpu.models.aec3 import config as j_a3cfg
from webrtc_audio_processing_tpu.models.aec3 import (
    multi_channel_content_detector as j_mccd,
)
from webrtc_audio_processing_tpu.models.aec3 import render_buffer as j_rb
from webrtc_audio_processing_tpu.ops import pallas_biquad

from webrtc_audio_processing_tpu_torch.models import echo_detector, post_filter
from webrtc_audio_processing_tpu_torch.models.aec3 import config as a3cfg
from webrtc_audio_processing_tpu_torch.models.aec3 import (
    multi_channel_content_detector as mccd,
)
from webrtc_audio_processing_tpu_torch.models.aec3 import render_buffer as rb
from webrtc_audio_processing_tpu_torch.ops import biquad, cuda_biquad, cuda_span

from tests.torch_aec3_setup import (
    assert_states_close,
    batched,
    flat,
    ordinal,
    t,
    torch_tree,
)

B = 3


def _tree(cfg):
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            out.update({f"{f.name}.{k}": w for k, w in _tree(v).items()})
        else:
            out[f.name] = v
    return out


@pytest.mark.parametrize("which", ["default", "multichannel", "clamped"])
def test_aec3_config_tree_and_validate_match_jax(which):
    def make(m):
        if which == "default":
            return m.EchoCanceller3Config()
        cfg = m.create_default_multichannel_config()
        if which == "clamped":
            cfg = cfg.replace(
                delay=dataclasses.replace(cfg.delay, down_sampling_factor=3,
                                          delay_estimate_smoothing=2.0),
                erle=dataclasses.replace(cfg.erle, min=9.0, num_sections=40))
        return cfg

    want, want_ok = j_a3cfg.validate(make(j_a3cfg))
    got, got_ok = a3cfg.validate(make(a3cfg))
    assert _tree(make(a3cfg)) == _tree(make(j_a3cfg))
    assert _tree(got) == _tree(want) and got_ok == want_ok


def _geometries():
    jcfg = j_a3cfg.create_default_multichannel_config()
    cfg = a3cfg.create_default_multichannel_config()
    return (jcfg, j_rb.BufferGeometry.create(jcfg, 48000, 2),
            cfg, rb.BufferGeometry.create(cfg, 48000, 2))


@functools.lru_cache(maxsize=None)
def _j_insert(slot):
    jcfg, jgeo, _, _ = _geometries()
    return jax.jit(jax.vmap(
        lambda s, blk, n: j_rb.insert(jgeo, jcfg, s, blk, n, sf_slot=slot),
        in_axes=(0, 0, None)))


@functools.lru_cache(maxsize=None)
def _j_flush():
    _, jgeo, _, _ = _geometries()
    return jax.jit(jax.vmap(
        lambda s, n: j_rb.flush_sf_pending(jgeo, s, n), in_axes=(0, None)))


def test_render_buffer_insert_flush_and_span_reads_match_jax():
    """Six frames of the paired cadence (flush at each even frame, then 2
    or 3 staged inserts), started from a JAX state in mid-stream so the
    ring writes wrap and touch the mirror. Ring rows, staging, low-rate
    ring, decimator state and the mixer's channel choice bit for bit; the
    FFT planes and spectra (jnp.fft and torch.fft round differently by
    ~1 ulp) and the mixer's 64-sample energy sums (another summation
    order) within 1e-6 of each row's scale. Then every span read of both
    packages on one state, bit for bit, for each pending count."""
    jcfg, jgeo, cfg, geo = _geometries()
    rng = np.random.default_rng(7)
    template = rb.init_state(geo, cfg, B, "cpu")
    js = batched(j_rb.init_state(jgeo, jcfg), B)
    # Mid-stream: random ring contents and read distances.
    js = js.replace(
        sf=rng.standard_normal(js.sf.shape).astype(np.float32),
        blocks=rng.standard_normal(js.blocks.shape).astype(np.float32),
        b_delay=rng.integers(1, 40, B).astype(np.int32),
        lr_latency=(16 * rng.integers(1, 40, B)).astype(np.int32))
    state = torch_tree(template, js)
    f0 = 63  # n0 = 157: the first flush wraps past L = 167
    for f in range(f0, f0 + 6):
        parity, n0 = f % 2, 5 * (f // 2) + 2 * (f % 2)
        if parity == 0:
            js = _j_flush()(js, jnp.int32(n0))
            state = rb.flush_sf_pending(geo, state, ordinal(n0))
        nblk = 2 if parity == 0 else 3
        base = 0 if parity == 0 else 2
        for k in range(nblk):
            blk = (rng.standard_normal((B, 3, 64, 2)) * 3000).astype(
                np.float32)
            js, jev = _j_insert(base + k)(js, blk, jnp.int32(n0 + k + 1))
            state, ev = rb.insert(geo, cfg, state, t(blk),
                                  ordinal(n0 + k + 1), sf_slot=base + k)
            np.testing.assert_array_equal(ev.numpy(), np.asarray(jev))
    want = flat(js)
    got = {k: v.detach().numpy() for k, v in _flat_torch(state).items()}
    fft_rows = ("sf", "sf_pending", "mixer.cumulative_energies")
    assert_states_close({k: v for k, v in got.items() if k not in fft_rows},
                        {k: v for k, v in want.items() if k not in fft_rows},
                        rtol=0.0)
    for k in fft_rows:
        scale = np.abs(want[k]).max(axis=-1, keepdims=True) + 1e-30
        assert (np.abs(got[k] - want[k]) / scale).max() <= 1e-6, k

    # Span reads on one state (the JAX state), both packages.
    state = torch_tree(template, js)
    n = 5 * ((f0 + 6) // 2)
    for pending in (0, 2, 5):
        view = rb.RenderView(state, ordinal(n), pending)
        starts = rng.integers(0, geo.num_blocks, B).astype(np.int32)
        for read, jread, W in ((rb.sf_span, j_rb.sf_span, 19),
                               (rb.blocks_span, j_rb.blocks_span, 15)):
            want_rows = jax.vmap(lambda st, s, r=jread, w=W: r(
                jgeo, j_rb.RenderView(st, jnp.int32(n), pending), s, w))(
                js, starts)
            np.testing.assert_array_equal(
                read(geo, view, t(starts), W).numpy(), np.asarray(want_rows))
        win = rb.block_window_back(geo, view, 13)
        jwin = jax.vmap(lambda st: j_rb.block_window_back(
            jgeo, j_rb.RenderView(st, jnp.int32(n), pending), 13))(js)
        np.testing.assert_array_equal(win.numpy(), np.asarray(jwin))


def _flat_torch(node, path=""):
    out = {}
    if dataclasses.is_dataclass(node):
        for f in dataclasses.fields(node):
            out.update(_flat_torch(getattr(node, f.name),
                                   f"{path}.{f.name}" if path else f.name))
    else:
        out[path] = node
    return out


@pytest.mark.parametrize("W,F", [(19, 512), (15, 384)])
def test_k2_twin_matches_dynamic_slice(W, F):
    """K2's twin against lax.dynamic_slice (pallas_span.py:123-127), bit
    for bit, with starts that need clamping."""
    rng = np.random.default_rng(W)
    ring = rng.standard_normal((B, 200, F)).astype(np.float32)
    starts = rng.integers(-250, 250, B).astype(np.int32)
    want = jax.vmap(lambda r, s: jax.lax.dynamic_slice(
        r, (s, 0), (W, F)))(ring, starts)
    got = cuda_span.span_gather(t(ring), t(starts), W)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _k1_tables():
    aa_b, aa_a = j_rb._LOW_PASS_DS4_B, j_rb._LOW_PASS_DS4_A
    return {
        "decimator_low_pass": (aa_b, aa_a, 64),
        "decimator_high_pass": (j_rb._HIGH_PASS_B, j_rb._HIGH_PASS_A, 64),
        "decimator_both": (np.concatenate([aa_b, j_rb._HIGH_PASS_B]),
                           np.concatenate([aa_a, j_rb._HIGH_PASS_A]), 64),
        "post_filter": (np.asarray(j_pf.COEFFS_B_48K),
                        np.asarray(j_pf.COEFFS_A_48K), 480),
    }


@pytest.mark.parametrize("table", sorted(_k1_tables()))
def test_k1_twin_matches_make_cascade_on_new_tables(table):
    """K1's twin against the jitted JAX cascade (the scan XLA:CPU
    contracts into fused multiply-adds) on the AEC3 decimators' and the
    PostFilter's coefficient tables, bit for bit."""
    b, a, T = _k1_tables()[table]
    K = b.shape[0]
    rng = np.random.default_rng(K + T)
    M = 6
    x = (rng.standard_normal((M, T)) * 3000).astype(np.float32)
    st = (rng.standard_normal((M, K, 4)) * 100).astype(np.float32)
    cascade = pallas_biquad.make_cascade(b, a)
    want_st, want_y = jax.jit(jax.vmap(cascade))(st, x)
    coeffs = t(biquad.pack_coeffs(b, a))
    got_st, got_y = cuda_biquad.cascade(
        coeffs, t(st.transpose(1, 2, 0).reshape(4 * K, M)), t(x.T))
    np.testing.assert_array_equal(got_y.numpy().T, np.asarray(want_y))
    np.testing.assert_array_equal(
        got_st.numpy().reshape(K, 4, M).transpose(2, 0, 1),
        np.asarray(want_st))


def test_decimator_and_post_filter_modules_match_jax():
    """The decimator through render_buffer.decimate (one launch for both
    cascades) and the PostFilter module, against the JAX modules."""
    jcfg, jgeo, cfg, geo = _geometries()
    rng = np.random.default_rng(3)
    js = batched(j_rb.init_state(jgeo, jcfg), B)
    x = (rng.standard_normal((B, 64)) * 3000).astype(np.float32)
    jst, jy = jax.jit(jax.vmap(lambda s, v: j_rb._decimate(jgeo, s, v)))(
        js, x)
    state = torch_tree(rb.init_state(geo, cfg, B, "cpu"), js)
    aa, nr, y = rb.decimate(4, state.decimator_aa, state.decimator_nr, t(x))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(aa.y.numpy(),
                                  np.asarray(jst.decimator_aa.y))
    np.testing.assert_array_equal(nr.x.numpy(),
                                  np.asarray(jst.decimator_nr.x))

    xs = (rng.standard_normal((B, 480, 2)) * 3000).astype(np.float32)
    jpf = batched(j_pf.init_state(2), B)
    jpf2, jout = jax.jit(jax.vmap(j_pf.process))(jpf, xs)
    pf = post_filter.PostFilter()
    st2, out = pf(torch_tree(post_filter.init_state(B, 2, "cpu"), jpf), t(xs))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(st2.filt.y.numpy(),
                                  np.asarray(jpf2.filt.y))


def test_content_detector_and_echo_detector_match_jax():
    """Ten frames: stereo appears on stream 1 only. The detector state
    exactly; the echo detector's statistics within 1e-5 of each leaf's
    scale (float sums in another order)."""
    rng = np.random.default_rng(5)
    mc = j_a3cfg.MultiChannel()
    js = batched(j_mccd.init_state(True, 2), B)
    state = torch_tree(mccd.init_state(True, 2, B, "cpu"), js)
    jed = batched(j_ed.init_state(), B)
    ed = torch_tree(echo_detector.init_state(B, "cpu"), jed)
    upd = jax.jit(jax.vmap(lambda s, r: j_mccd.update(
        s, r, True, mc.stereo_detection_threshold, 1, 0.05)))
    ed_r = jax.jit(jax.vmap(j_ed.analyze_render_audio))
    ed_c = jax.jit(jax.vmap(j_ed.analyze_capture_audio))
    for f in range(10):
        r = (rng.standard_normal((B, 3, 160, 1)) * 1000).astype(np.float32)
        r = np.concatenate([r, r], axis=-1)
        r[1, :, :, 1] += 5.0
        js, jch = upd(js, r)
        state, ch = mccd.update(state, t(r), True,
                                mc.stereo_detection_threshold, 1, 0.05)
        np.testing.assert_array_equal(ch.numpy(), np.asarray(jch))
        ren = (rng.standard_normal((B, 480, 2)) * 1000).astype(np.float32)
        cap = (rng.standard_normal((B, 480, 2)) * 1000).astype(np.float32)
        jed = ed_c(ed_r(jed, ren), cap)
        ed = echo_detector.analyze_capture_audio(
            echo_detector.analyze_render_audio(ed, t(ren)), t(cap))
    assert_states_close({k: v.numpy() for k, v in _flat_torch(state).items()},
                        flat(js), rtol=0.0)
    assert_states_close({k: v.numpy() for k, v in _flat_torch(ed).items()},
                        flat(jed), rtol=1e-5)
