"""The AEC3 echo remover of the port against the JAX package on the CPU:
``echo_remover.process_capture_pair`` (subtractor, AEC state, comfort
noise, residual echo, suppression gain and filter) over one frame pair
from a warm state, the bit tricks of ``fast_approx_log2``, and the three
estimators the default configuration leaves off (adaptive reverb decay,
signal-dependent ERLE, echo audibility)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from webrtc_audio_processing_tpu.models.aec3 import (
    aec_state as j_aecs,
    echo_audibility as j_ea,
    echo_remover as j_er,
    render_buffer as j_rb,
    reverb_decay_estimator as j_rde,
    signal_dependent_erle as j_sde,
)

from webrtc_audio_processing_tpu_torch import apm
from webrtc_audio_processing_tpu_torch.models.aec3 import (
    echo_audibility as ea,
    echo_remover as er,
    render_buffer as rb,
    reverb_decay_estimator as rde,
    signal_dependent_erle as sde,
)
from webrtc_audio_processing_tpu_torch.models.aec3.fast_log2 import (
    fast_approx_log2,
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


def test_fast_approx_log2_bit_for_bit():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        np.exp(rng.uniform(-80, 80, 20000)), [0.0, 1e-40, 1.0, 2.0, 3e38],
    ]).astype(F32)
    want = np.asarray(jax.jit(j_aecs.fast_approx_log2)(x))
    np.testing.assert_array_equal(fast_approx_log2(t(x)).numpy(), want)
    np.testing.assert_array_equal(
        np.asarray(jax.jit(j_rde._log2f)(x)), want)


@functools.lru_cache(maxsize=None)
def _j_pair(nb):
    jgeo = geometries()[0].aec3
    cfg = jgeo.config
    pending = 2 if nb == 2 else 5

    def run(rem, buf, blocks, dchanges, sat, edl, evl, n):
        views = [j_rb.RenderView(buf, n, pending)] * nb
        return j_er.process_capture_pair(
            cfg, rem, jgeo.buffer, views, list(blocks), list(dchanges),
            jnp.asarray(False), sat, list(edl), list(evl))

    return jax.jit(jax.vmap(run, in_axes=(0, 0, 1, 1, 0, 1, 1, None)))


def _warm_states(rng):
    """A remover state with random filters and a mix of flags, and a
    render buffer with random rings, both batch-first JAX pytrees."""
    jgeo = geometries()[0].aec3
    cfg = jgeo.config
    rem = batched(j_er.init_state(cfg, 3, 2, 2), B)
    sub = rem.subtractor

    def cplx(shape, scale):
        return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
                ).astype(np.complex64) * scale

    sub = sub.replace(
        refined=sub.refined.replace(H=cplx(sub.refined.H.shape, 0.05)),
        coarse=sub.coarse.replace(H=cplx(sub.coarse.H.shape, 0.05)),
        refined_frequency_responses=rng.uniform(
            0, 0.01, sub.refined_frequency_responses.shape).astype(F32),
        refined_impulse_responses=(rng.standard_normal(
            sub.refined_impulse_responses.shape) * 0.05).astype(F32))
    aec = rem.aec.replace(
        usable_linear_estimate=np.array([False, True, True]),
        transition_triggered=np.array([False, False, True]),
        min_filter_delay=np.array([1, 3, 5], np.int32))
    rem = rem.replace(subtractor=sub, aec=aec)
    buf = batched(j_rb.init_state(jgeo.buffer, cfg), B)
    buf = buf.replace(
        sf=(rng.standard_normal(buf.sf.shape) * 3e3).astype(F32),
        sf_pending=(rng.standard_normal(buf.sf_pending.shape) * 3e3
                    ).astype(F32),
        blocks=(rng.standard_normal(buf.blocks.shape) * 3e3).astype(F32),
        blocks_pending=(rng.standard_normal(buf.blocks_pending.shape) * 3e3
                        ).astype(F32),
        b_delay=np.array([3, 40, 90], np.int32))
    # The spectrum part of each sf row must be |FFT|^2 of its planes.
    for name in ("sf", "sf_pending"):
        rows = getattr(buf, name)
        f, s = jgeo.buffer.fft_row_f, jgeo.buffer.spec_row_f
        re, im = rows[..., : f // 2], rows[..., f // 2: f]
        rows[..., f: f + s] = re * re + im * im
        rows[..., f + s:] = 0.0
    return rem, buf


def test_process_capture_pair_matches_jax():
    """One frame pair (2 then 3 capture blocks) from a warm state with a
    delay change on one block. Output blocks and linear outputs within
    relative RMS 1e-5 per stream; the state leaf by leaf, integer and
    boolean leaves exact, float leaves within 1e-4 of each leaf's scale
    and the comfort-noise seed exact."""
    jgeo_apm, geo_apm = geometries()
    geo = geo_apm.aec3
    rng = np.random.default_rng(17)
    rem, buf = _warm_states(rng)
    state = torch_tree(er.init_state(geo.config, 3, 2, 2, B, "cpu"), rem)
    bstate = torch_tree(rb.init_state(geo.buffer, geo.config, B, "cpu"), buf)
    n = 500
    for nb in (2, 3):
        blocks = (rng.standard_normal((nb, B, 3, 64, 2)) * 2000).astype(F32)
        dch = np.zeros((nb, B), bool)
        dch[nb - 1, 1] = True
        sat = np.array([False, False, True])
        edl = rng.integers(0, 8, (nb, B)).astype(np.int32)
        evl = rng.uniform(size=(nb, B)) > 0.5
        rem, jouts, jlins = _j_pair(nb)(rem, buf, blocks, dch, sat, edl,
                                        evl, jnp.int32(n))
        views = [rb.RenderView(bstate, ordinal(n), 2 if nb == 2 else 5)] * nb
        state, outs, lins = er.process_capture_pair(
            geo.config, state, geo.buffer, views, list(t(blocks)),
            list(t(dch)), t(np.zeros(B, bool)), t(sat), list(t(edl)),
            list(t(evl)))
        for got, want in zip(outs + lins, jouts + jlins):
            got, want = got.numpy(), np.asarray(want)
            err = ((got - want) ** 2).reshape(B, -1).sum(1)
            ref = (want ** 2).reshape(B, -1).sum(1) + 1e-30
            assert (np.sqrt(err / ref) <= 1e-5).all(), np.sqrt(err / ref)
        assert_states_close(apm.state_to_numpy(state), flat(rem), rtol=1e-4)
        n += nb


def test_reverb_decay_estimator_update_matches_jax():
    """The adaptive decay path (ep_strength.default_len < 0): thirty
    updates of random filters, the state within 1e-4 of each leaf's
    scale, integer and boolean leaves exact. One capture channel: the JAX
    twin's per-channel selects broadcast a (C,) flag against (C, L) leaves
    from the right, which traces only for C = 1 (ROADMAP Queue 3)."""
    cfg_j = _adaptive_decay_config(j_rde)
    rng = np.random.default_rng(4)
    C = 1
    jst = batched(j_rde.init_state(cfg_j, C), B)
    st = torch_tree(rde.init_state(cfg_j, C, B, "cpu"), jst)
    upd = jax.jit(jax.vmap(functools.partial(j_rde.update, cfg_j)))
    L = cfg_j.filter.refined.length_blocks
    decay = np.exp(-np.arange(L * 64) / 300.0).astype(F32)
    for _ in range(30):
        h = (rng.standard_normal((B, C, L * 64)) * decay * 0.3).astype(F32)
        q = rng.uniform(0.2, 1, (B, C)).astype(F32)
        qv = rng.uniform(size=(B, C)) > 0.2
        fdb = rng.integers(0, 4, (B, C)).astype(np.int32)
        usable = rng.uniform(size=B) > 0.1
        stat = rng.uniform(size=B) > 0.9
        size = np.full(B, L, np.int32)
        jst = upd(jst, h, q, qv, fdb, usable, stat, size)
        st = rde.update(cfg_j, st, t(h), t(q), t(qv), t(fdb), t(usable),
                        t(stat), t(size))
    assert_states_close(apm.state_to_numpy(st), flat(jst), rtol=1e-4)


def _adaptive_decay_config(mod):
    del mod
    from webrtc_audio_processing_tpu.models.aec3 import config as j_a3cfg

    cfg = j_a3cfg.EchoCanceller3Config()
    return cfg.replace(ep_strength=dataclasses.replace(
        cfg.ep_strength, default_len=-0.83))


def test_signal_dependent_erle_update_matches_jax():
    """erle.num_sections = 4: twenty updates of random spectra."""
    from webrtc_audio_processing_tpu.models.aec3 import config as j_a3cfg

    base = j_a3cfg.EchoCanceller3Config()
    cfg = base.replace(erle=dataclasses.replace(base.erle, num_sections=4))
    rng = np.random.default_rng(8)
    C = 2
    jst = batched(j_sde.init_state(cfg, C), B)
    st = torch_tree(sde.init_state(cfg, C, B, "cpu"), jst)
    upd = jax.jit(jax.vmap(functools.partial(j_sde.update, cfg)))
    for _ in range(20):
        X2d = rng.uniform(0, 1e8, (B, 13, 65)).astype(F32)
        fr = rng.uniform(0, 1, (B, C, 13, 65)).astype(F32)
        X2 = rng.uniform(1e7, 1e9, (B, 65)).astype(F32)
        Y2 = rng.uniform(1e6, 1e9, (B, C, 65)).astype(F32)
        E2 = rng.uniform(1e5, 1e8, (B, C, 65)).astype(F32)
        avg = rng.uniform(1, 4, (B, C, 65)).astype(F32)
        avg_oc = rng.uniform(1, 4, (B, C, 65)).astype(F32)
        conv = rng.uniform(size=(B, C)) > 0.2
        jst = upd(jst, X2d, fr, X2, Y2, E2, avg, avg_oc, conv)
        st = sde.update(cfg, st, *(t(a) for a in (X2d, fr, X2, Y2, E2, avg,
                                                  avg_oc, conv)))
    assert_states_close(apm.state_to_numpy(st), flat(jst), rtol=1e-5)


def test_echo_audibility_update_matches_jax():
    """use_stationarity_properties on: ten updates reading the spectra of
    a random render buffer (through K2's twin), the state within 1e-5."""
    jgeo = geometries()[0].aec3
    geo = geometries()[1].aec3
    rng = np.random.default_rng(12)
    _, buf = _warm_states(rng)
    bstate = torch_tree(rb.init_state(geo.buffer, geo.config, B, "cpu"), buf)
    jst = batched(j_ea.init_state(), B)
    st = torch_tree(ea.init_state(B, "cpu"), jst)
    n = 700

    def jupd(s, b, newest, reverb, delay, ext):
        view = j_rb.RenderView(b, jnp.int32(n), 5)
        return j_ea.update(s, view, j_rb.s_read_index(jgeo.buffer, b, n),
                           j_rb.s_write_index(jgeo.buffer, n), jgeo.buffer,
                           newest, reverb, delay,
                           j_rb.headroom(jgeo.buffer, b), ext, False)

    upd = jax.jit(jax.vmap(jupd))
    view = rb.RenderView(bstate, ordinal(n), 5)
    for _ in range(10):
        newest = (rng.standard_normal((B, 64, 2)) * 50).astype(F32)
        reverb = rng.uniform(0, 1e6, (B, 65)).astype(F32)
        delay = rng.integers(0, 6, B).astype(np.int32)
        ext = rng.uniform(size=B) > 0.3
        jst = upd(jst, buf, newest, reverb, delay, ext)
        st = ea.update(st, geo.buffer, view,
                       rb.s_read_index(geo.buffer, bstate, ordinal(n)),
                       rb.s_write_index(geo.buffer, ordinal(n)), t(newest),
                       t(reverb),
                       t(delay), rb.headroom(geo.buffer, bstate), t(ext),
                       False)
    assert_states_close(apm.state_to_numpy(st), flat(jst), rtol=1e-5)
