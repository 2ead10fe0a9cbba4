"""AEC3's per-block capture path against the JAX package on the CPU:
``echo_canceller3.process_frame`` with ``pair_phase=False`` at 16 kHz mono
for both frame parities with an injected neural residual echo estimator
and the debug taps; ``subtractor.process`` and
``echo_remover.process_capture`` (no estimator) for one block, and
``echo_remover.process_capture_pair`` with the estimator and the taps for
one frame's three blocks, from the same state; the fixed capture
pre-delay's shift on both paths. B = 2 streams of a mono echo scene for 8
frames, in floatS16. The JAX steps, one stream each, compile side by
side, once, in the module fixture.

``-m slow`` adds the 48 kHz stereo APM on the per-block path.
"""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke

from webrtc_audio_processing_tpu import builder as j_builder
from webrtc_audio_processing_tpu.models.aec3 import (
    config as j_a3cfg,
    echo_canceller3 as j_ec3,
    echo_remover as j_er,
    render_buffer as j_rb,
    subtractor as j_subt,
)

from webrtc_audio_processing_tpu_torch import apm, builder
from webrtc_audio_processing_tpu_torch.models.aec3 import (
    config as a3cfg,
    echo_canceller3 as ec3,
    echo_remover as er,
    render_buffer as rb,
    subtractor as subt,
)

from tests.torch_aec3_setup import (
    assert_states_close,
    batched,
    flat,
    geometries,
    ordinal,
    t,
    torch_tree,
)

B = 2
N_FRAMES = 8
STATE_FRAME = 2  # the states are compared after this frame
RATE = 16000
FRAME = RATE // 100
PREDELAY = 64
F32 = np.float32

# name: (pair_phase, nree, fixed capture pre-delay), with the debug taps.
VARIANTS = {
    "per_block": (False, True, 0),
}


def _nree_estimate(m, calls):
    """A residual that reads every input: the linear echo S2, a little of
    E2 and Y2, the render block's power, the product of y and e, doubled
    where the dominant near end is detected. ``m`` is jnp or torch."""
    def estimate(render, y, e, S2, Y2, E2, dominant_nearend):
        calls.append(tuple(render.shape))
        power = m.mean(render * render, -1)[..., None]
        ye = m.mean(y * e, -1)[..., None]
        dn = dominant_nearend
        if m is torch:
            dn = dn[:, None, None]
        R2 = 0.5 * S2 + 1e-3 * E2 + 1e-4 * Y2 + 1e-6 * power + 1e-9 * ye
        R2 = R2 * m.where(dn, 2.0, 1.0)
        return R2, 1.5 * R2

    return estimate


def _config(m_cfg, predelay):
    cfg, _ = m_cfg.validate(m_cfg.EchoCanceller3Config())
    return cfg.replace(delay=dataclasses.replace(
        cfg.delay, fixed_capture_delay_samples=predelay))


def _geometries(variant, calls):
    pair_phase, nree, predelay = VARIANTS[variant]
    jgeo = j_ec3.Aec3Geometry.create(
        _config(j_a3cfg, predelay), RATE, 1, 1,
        nree=(j_builder.NeuralResidualEchoEstimator(
            _nree_estimate(jnp, [])) if nree else None),
        debug_taps=True, pair_phase=pair_phase, pair_kernel=False)
    geo = ec3.Aec3Geometry.create(
        _config(a3cfg, predelay), RATE, 1, 1,
        nree=(builder.NeuralResidualEchoEstimator(
            _nree_estimate(torch, calls)) if nree else None),
        debug_taps=True, pair_phase=pair_phase)
    return jgeo, geo


def _scene():
    """(render, capture), each (N_FRAMES, B, 1 band, 160, 1) in floatS16."""
    render, capture = chip_smoke.echo_scene(N_FRAMES, seed=9,
                                            streams=range(B), rate=RATE,
                                            channels=1)

    def frames(x):
        x = x.reshape(B, N_FRAMES, FRAME, 1).transpose(1, 0, 2, 3)
        return np.ascontiguousarray(x[:, :, None] * 32768.0, dtype=F32)

    return frames(render), frames(capture)


def _jax_step(jgeo, parity):
    """The JAX step of one stream (a batch of one would compile the same
    program at twice the cost under vmap)."""
    js = j_ec3.init_state(jgeo)
    r = np.zeros((1, FRAME, 1), F32)
    step = jax.jit(lambda s, r, c, n0: j_ec3.process_frame(
        jgeo, s, r, c, parity, n0=n0))
    return step.lower(js, r, r, jnp.int32(0)).compile()


def _stack(trees):
    return jax.tree_util.tree_map(lambda *a: np.stack(a), *trees)


def _jax_frame(step, states, r, c, n0):
    """Every stream through the one-stream step; outputs stacked."""
    outs = [step(states[b], r[b], c[b], jnp.int32(n0)) for b in range(B)]
    states = [jax.tree_util.tree_map(np.asarray, o[0]) for o in outs]
    return (states,) + tuple(_stack([o[i] for o in outs]) for i in (1, 2, 3))


def _run(variant, steps, jgeo, geo, renders, captures, calls):
    jstates = [jax.tree_util.tree_map(np.asarray, j_ec3.init_state(jgeo))
               for _ in range(B)]
    state = torch_tree(ec3.init_state(geo, B, "cpu"), _stack(jstates))
    out = {"jax": [], "torch": [], "jax_linear": [], "torch_linear": [],
           "jax_taps": [], "torch_taps": [], "geo": geo, "jgeo": jgeo}
    for f in range(N_FRAMES):
        n0 = apm.block_ordinal(f)
        jstates, jy, jlin, jtaps = _jax_frame(steps[f % 2], jstates,
                                              renders[f], captures[f], n0)
        js = _stack(jstates)
        state, y, lin, taps = ec3.process_frame(
            geo, state, t(renders[f]), t(captures[f]), f % 2, ordinal(n0))
        out["jax"].append(np.asarray(jy))
        out["torch"].append(y.numpy())
        out["jax_linear"].append(np.asarray(jlin))
        out["torch_linear"].append(lin.numpy())
        out["jax_taps"].append({k: np.asarray(v) for k, v in jtaps.items()})
        out["torch_taps"].append({k: v.numpy() for k, v in taps.items()})
        if f == STATE_FRAME:
            out["jax_state"] = flat(js)
            out["torch_state"] = apm.state_to_numpy(state)
            out["jax_tree"] = js
    out["nree_calls"] = len(calls)
    return out


@pytest.fixture(scope="module")
def runs():
    renders, captures = _scene()
    calls = {v: [] for v in VARIANTS}
    geos = {v: _geometries(v, calls[v]) for v in VARIANTS}
    with concurrent.futures.ThreadPoolExecutor(2 * len(VARIANTS)) as pool:
        futures = {(v, p): pool.submit(_jax_step, geos[v][0], p)
                   for v in VARIANTS for p in (0, 1)}
        steps = {k: f.result() for k, f in futures.items()}
    return {v: _run(v, [steps[(v, 0)], steps[(v, 1)]], *geos[v], renders,
                    captures, calls[v]) for v in VARIANTS}


def _rel_rms_per_stream(got, want):
    """Relative RMS per stream of (frames, B, ...) arrays."""
    axes = (0,) + tuple(range(2, got.ndim))
    err = np.sqrt(((got - want) ** 2).sum(axis=axes))
    return err / np.maximum(np.sqrt((want ** 2).sum(axis=axes)), 1.0)


def test_geometry_flags():
    g = ec3.Aec3Geometry.create(a3cfg.EchoCanceller3Config(), RATE, 1, 1,
                                pair_phase=False)
    assert not g.pair_phase and g.nree is None and not g.debug_taps
    with pytest.raises(ValueError, match="pair_phase"):
        ec3.Aec3Geometry.create(a3cfg.EchoCanceller3Config(), RATE, 1, 1,
                                pair_phase=False, pair_kernel=True)


@pytest.mark.parametrize("parity", (0, 1))
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_output_matches_jax(runs, variant, parity):
    """The frames of one parity: relative RMS <= 1e-3 per stream (the
    BASELINE.md bar), the linear output too."""
    r = runs[variant]
    frames = range(parity, N_FRAMES, 2)
    for key in ("", "_linear"):
        got = np.stack([r[f"torch{key}"][f] for f in frames])
        want = np.stack([r[f"jax{key}"][f] for f in frames])
        assert got.shape == want.shape
        assert np.isfinite(got).all()
        rel = _rel_rms_per_stream(got, want)
        assert (rel <= 1e-3).all(), (key, rel)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_state_after_frame_2_matches_jax(runs, variant):
    """Every leaf of AEC3's state, the pre-delay line included: integer and
    boolean leaves exact, float leaves within 1e-4 of each leaf's scale
    (tests/test_torch_apm_16k_mono.py's bar)."""
    r = runs[variant]
    assert_states_close(r["torch_state"], r["jax_state"], rtol=1e-4)
    assert r["torch_state"]["capture_predelay"].shape == (B, 1, 0, 1)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_debug_taps_match_jax(runs, variant):
    """The JAX package's tap names; each frame's last block's values:
    flags and delays exact, the rest within 1e-3 of each tap's scale, or
    of 1 (one int16 step, or its power) where the scale is smaller (AEC3's
    start-up silence)."""
    r = runs[variant]
    for f in range(N_FRAMES):
        got, want = r["torch_taps"][f], r["jax_taps"][f]
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            g = got[k]
            assert g.shape == w.shape, k
            if w.dtype.kind in "iub":
                np.testing.assert_array_equal(g, w, err_msg=k)
            else:
                scale = max(float(np.abs(w).max()), 1.0)
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-3 * scale,
                                           err_msg=f"{k} frame {f}")


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_nree_is_called_on_every_block(runs, variant):
    """5 blocks a frame pair; the taps' R2 is its residual, bounded here
    from the taps' spectra."""
    r = runs[variant]
    assert r["nree_calls"] == apm.block_ordinal(N_FRAMES)
    taps = r["torch_taps"][-1]
    S2, E2, Y2 = taps["aec3_S2_linear"], taps["aec3_E2"], taps["aec3_Y2"]
    assert np.all(taps["aec3_R2"] >= 0.5 * S2 * (1 - 1e-6))
    assert np.all(taps["aec3_R2"] >= 1e-3 * E2 * (1 - 1e-6))
    assert np.isfinite(E2).all() and np.isfinite(Y2).all()


def test_per_block_path_equals_the_pair_path_where_staleness_is_idle():
    """The same frames through both paths without the estimator: on a
    noise echo scene, with no narrow band for the analyzer's delay to mask
    and before the initial-state transition, the pair path's two
    staleness rules (echo_canceller3.py:52-58) do not act, and the
    per-block path computes the same outputs bit for bit, in the same
    order."""
    renders, captures = _scene()
    outs = {}
    for pair_phase in (True, False):
        geo = ec3.Aec3Geometry.create(_config(a3cfg, 0), RATE, 1, 1,
                                      pair_phase=pair_phase)
        state = ec3.init_state(geo, B, "cpu")
        outs[pair_phase] = []
        for f in range(N_FRAMES):
            state, y, _ = ec3.process_frame(geo, state, t(renders[f]),
                                            t(captures[f]), f % 2,
                                            ordinal(apm.block_ordinal(f)))
            outs[pair_phase].append(y.numpy())
    np.testing.assert_array_equal(np.stack(outs[False]),
                                  np.stack(outs[True]))


# --------------------------------------------------- one block per module


def _from_jax(r):
    """The port's AEC3 state from the JAX run's state after frame 2 (the
    port's own run has moved its rings on in place since)."""
    return torch_tree(ec3.init_state(r["geo"], B, "cpu"), r["jax_tree"])


def _per_stream(step, *args, **kw):
    """``step`` on each stream's slice of the batch-first ``args``; the
    outputs stacked."""
    outs = [step(*jax.tree_util.tree_map(lambda a, b=b: a[b], args), **kw)
            for b in range(B)]
    return _stack(outs)


def test_subtractor_process_matches_jax(runs):
    """``subtractor.process`` for one block from the per-block run's state
    after frame 2, random render FFTs and capture: the outputs and the
    state at the pair path's module bars (tests/test_torch_aec3_remover.py:
    relative RMS 1e-5 and 1e-4 of each leaf's scale)."""
    r = runs["per_block"]
    cfg = r["geo"].config
    rng = np.random.default_rng(3)
    js = r["jax_tree"].remover
    P = js.subtractor.refined.H.shape[2]
    X = ((rng.standard_normal((B, P, 1, 65))
          + 1j * rng.standard_normal((B, P, 1, 65))) * 3e3).astype(
        np.complex64)
    X[..., 0] = X[..., 0].real
    X[..., 64] = X[..., 64].real
    X2 = (np.abs(X) ** 2).sum(axis=(1, 2)).astype(F32)
    X2c = (0.7 * X2).astype(F32)
    y = (rng.standard_normal((B, 1, 64)) * 2000).astype(F32)
    sat = np.array([False, True])
    step = jax.jit(lambda s, X, a, b, y, an, sat: j_subt.process(
        r["jgeo"].config, s, X, a, b, y, an, sat))
    jsub, jout = _per_stream(step, js.subtractor, X, X2, X2c, y, js.analyzer,
                             sat)
    port = _from_jax(r).remover
    sub, out = subt.process(cfg, port.subtractor, t(X), t(X2), t(X2c), t(y),
                            port.analyzer, t(sat))
    for k, w in jout.items():
        w = np.asarray(w)
        g = out[k].numpy()
        assert g.shape == w.shape, k
        scale = max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * scale,
                                   err_msg=k)
    assert_states_close(apm.state_to_numpy(sub), flat(jsub), rtol=1e-4)


def test_process_capture_matches_jax(runs):
    """``echo_remover.process_capture`` for one block from the per-block
    run's state after frame 2 (remover and render buffer), a random
    capture block, a delay change on stream 1: output block and linear
    output within relative RMS 1e-5 per stream, the state leaf by leaf
    within 1e-4 of each leaf's scale, integer leaves and the comfort-noise
    seed exact (tests/test_torch_aec3_remover.py's bars)."""
    r = runs["per_block"]
    jgeo, geo = r["jgeo"], r["geo"]
    rng = np.random.default_rng(4)
    jtree, tree = r["jax_tree"], _from_jax(r)
    n = apm.block_ordinal(STATE_FRAME + 1)
    block = (rng.standard_normal((B, 1, 64, 1)) * 2000).astype(F32)
    dch = np.array([False, True])
    gch = np.array([False, False])
    sat = np.array([False, False])
    edl = np.array([3, 5], np.int32)
    evl = np.array([True, False])

    def one(rem, buf, blk, d, g, s, e, v, n):
        return j_er.process_capture(
            jgeo.config, rem, jgeo.buffer, j_rb.RenderView(buf, n, 2), blk,
            d, g, s, e, v)

    step = jax.jit(one)
    jrem, jout, jlin = _per_stream(
        step, jtree.remover, jtree.buffer, block, dch, gch, sat, edl, evl,
        n=jnp.int32(n))
    rem, out, lin = er.process_capture(
        geo.config, tree.remover, geo.buffer,
        rb.RenderView(tree.buffer, ordinal(n), 2), t(block), t(dch), t(gch),
        t(sat), t(edl), t(evl))
    for g, w in ((out.numpy(), np.asarray(jout)), (lin.numpy(),
                                                    np.asarray(jlin))):
        assert g.shape == w.shape
        assert (_rel_rms_per_stream(g[None], w[None]) <= 1e-5).all()
    assert_states_close(apm.state_to_numpy(rem), flat(jrem), rtol=1e-4,
                        exact=("cng.seed",))


def test_process_capture_pair_with_nree_and_taps_matches_jax(runs):
    """The pair path's echo remover for one frame's three blocks from the
    per-block run's state after frame 2, with the estimator and the taps:
    the outputs within relative RMS 1e-5 per stream, the state within
    1e-4 of each leaf's scale, the estimator called on every block, the
    last block's taps within 1e-4 of each tap's scale."""
    r = runs["per_block"]
    jgeo, geo = r["jgeo"], r["geo"]
    jtree, tree = r["jax_tree"], _from_jax(r)
    rng = np.random.default_rng(5)
    n = apm.block_ordinal(STATE_FRAME + 1)
    blocks = (rng.standard_normal((3, B, 1, 64, 1)) * 2000).astype(F32)
    dch = np.zeros((3, B), bool)
    dch[1, 1] = True
    sat = np.array([False, True])
    edl = rng.integers(0, 8, (3, B)).astype(np.int32)
    evl = rng.uniform(size=(3, B)) > 0.5
    calls = []
    jnree = j_builder.NeuralResidualEchoEstimator(_nree_estimate(jnp, []))

    def one(rem, buf, blk, d, s, e, v, n):
        taps = {}
        views = [j_rb.RenderView(buf, n, 2)] * 3
        rem, outs, lins = j_er.process_capture_pair(
            jgeo.config, rem, jgeo.buffer, views, list(blk), list(d),
            jnp.asarray(False), s, list(e), list(v), nree=jnree, taps=taps)
        return rem, jnp.stack(outs), jnp.stack(lins), taps

    step = jax.jit(one)
    jrem, jout, jlin, jtaps = _per_stream(
        step, jtree.remover, jtree.buffer, np.moveaxis(blocks, 1, 0),
        np.moveaxis(dch, 1, 0), sat, np.moveaxis(edl, 1, 0),
        np.moveaxis(evl, 1, 0), n=jnp.int32(n))
    taps = {}
    view = rb.RenderView(tree.buffer, ordinal(n), 2)
    rem, outs, lins = er.process_capture_pair(
        geo.config, tree.remover, geo.buffer, [view] * 3,
        [t(b) for b in blocks], [t(d) for d in dch],
        torch.zeros(B, dtype=torch.bool), t(sat), [t(e) for e in edl],
        [t(v) for v in evl],
        nree=builder.NeuralResidualEchoEstimator(_nree_estimate(torch,
                                                                calls)),
        taps=taps)
    assert len(calls) == 3
    got = (torch.stack(outs, 1).numpy(), torch.stack(lins, 1).numpy())
    for g, w in zip(got, (np.asarray(jout), np.asarray(jlin))):
        assert g.shape == w.shape
        assert (_rel_rms_per_stream(np.moveaxis(g, 1, 0),
                                    np.moveaxis(w, 1, 0)) <= 1e-5).all()
    assert_states_close(apm.state_to_numpy(rem), flat(jrem), rtol=1e-4,
                        exact=("cng.seed",))
    assert sorted(taps) == sorted(jtaps)
    for k, w in jtaps.items():
        w = np.asarray(w)
        g = taps[k].numpy()
        if w.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            scale = max(float(np.abs(w).max()), 1.0)
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * scale,
                                       err_msg=k)


# ------------------------------------------------------------- pre-delay


@pytest.mark.parametrize("pair_phase", (True, False))
def test_fixed_capture_predelay_shifts_output(pair_phase):
    """tests/test_sd_erle_and_predelay.py:127-155 on the port: an impulse
    in frame 4 comes out 64 samples later with the pre-delay on."""
    def run(delay_samples):
        geo = ec3.Aec3Geometry.create(_config(a3cfg, delay_samples), RATE,
                                      1, 1, pair_phase=pair_phase)
        state = ec3.init_state(geo, 1, "cpu")
        outs = []
        for k in range(8):
            far = torch.zeros((1, 1, 160, 1))
            near = torch.zeros((1, 1, 160, 1))
            if k == 4:
                near[0, 0, 10, 0] = 8000.0
            state, out, _ = ec3.process_frame(
                geo, state, far, near, k % 2,
                ordinal(apm.block_ordinal(k)))
            outs.append(out[0, 0, :, 0].numpy())
        return np.concatenate(outs)

    base = run(0)
    delayed = run(PREDELAY)
    assert np.argmax(np.abs(delayed)) - np.argmax(np.abs(base)) == PREDELAY


# ------------------------------------------ 48 kHz stereo APM, -m slow


@pytest.mark.slow
def test_48k_stereo_apm_per_block_matches_jax():
    """The bench's 48 kHz stereo APM on the per-block path, 6 frames of the
    echo scene at B = 2: relative RMS <= 1e-3 per stream and the same
    delays on every frame."""
    from webrtc_audio_processing_tpu import apm as j_apm

    from tests.torch_aec3_setup import echo_scene

    jgeo, geo = geometries()
    jgeo = dataclasses.replace(jgeo, aec3=dataclasses.replace(
        jgeo.aec3, pair_phase=False))
    geo = dataclasses.replace(geo, aec3=dataclasses.replace(
        geo.aec3, pair_phase=False))
    n = 6
    renders, captures = echo_scene(n, B, seed=3)
    js = batched(j_apm.init_state(jgeo), B)
    state = apm.state_from_jax(js, geo)

    def compiled(parity):
        step = jax.jit(jax.vmap(
            lambda s, c, r, n0: j_apm.process_stream_pair(
                jgeo, s, c, r, parity, n0=n0), in_axes=(0, 0, 0, None)))
        return step.lower(js, captures[0], renders[0], jnp.int32(0)).compile()

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        steps = list(pool.map(compiled, (0, 1)))
    got, want = [], []
    for f in range(n):
        js, jy, _, jstats = steps[f % 2](js, captures[f], renders[f],
                                         jnp.int32(apm.block_ordinal(f)))
        state, y, _, stats = apm.process_stream_pair(
            geo, state, t(captures[f]), t(renders[f]))
        want.append(np.asarray(jy))
        got.append(y.numpy())
        np.testing.assert_array_equal(stats["delay_ms"].numpy(),
                                      np.asarray(jstats["delay_ms"]))
    rel = _rel_rms_per_stream(np.stack(got), np.stack(want))
    assert (rel <= 1e-3).all(), rel
