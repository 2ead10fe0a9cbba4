"""The AEC3 subtractor on the pair kernel K6, on the CPU: the marshal
(``subtractor_kernel.process_pair_kernel``, which on the CPU runs K6's twin
on windows cut from the sf chain) against the JAX package's
``subtractor.process_pair``, the APM with the switch on against the APM with
it off, and the switch itself."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke

from webrtc_audio_processing_tpu.models.aec3 import config as j_aec3_config
from webrtc_audio_processing_tpu.models.aec3 import subtractor as j_subt

from webrtc_audio_processing_tpu_torch import apm
from webrtc_audio_processing_tpu_torch.models.aec3 import (
    config as ac,
    echo_canceller3 as ec3,
    subtractor_kernel,
)
from webrtc_audio_processing_tpu_torch.ops import cuda_subtractor

from tests.torch_aec3_setup import assert_states_close, flat

OUT_KEYS = cuda_subtractor.SCALAR_KEYS + (
    "e_refined", "e_coarse", "refined_frequency_responses",
    "refined_impulse_responses")


def _jax_state(template, numpy_leaves: dict):
    """The JAX pytree ``template`` with its leaves replaced by the port's
    (dotted paths as ``apm.state_to_numpy`` names them)."""
    paths, treedef = jax.tree_util.tree_flatten_with_path(template)
    return jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(numpy_leaves[jax.tree_util.keystr(p)[1:]])
        for p, _ in paths])


@pytest.mark.parametrize("nb,C,R,events", [
    (2, 1, 1, False), (2, 1, 1, True), (3, 2, 2, False), (3, 2, 2, True)])
def test_marshal_matches_jax_process_pair(nb, C, R, events):
    """B = 4 streams of random state and chains (chip_smoke.k6_inputs: the
    state of tests/test_subtractor_pallas.py plus counters that reach the
    rescale, the coarse reset, the hangover and a size change), mono with
    the default config and stereo with the multichannel one. The state
    leaf by leaf and every per-block output: float leaves within 1e-4 of
    their scale, integer and boolean leaves exact."""
    _check_marshal_against_jax(nb, C, R, events, below_gate=False)


@pytest.mark.parametrize("nb,C,R", [(3, 1, 1), (3, 2, 2)])
def test_marshal_matches_jax_process_pair_below_the_noise_gate(nb, C, R):
    """The same with render spectra below the gains' noise gate, where no
    filter adapts and the refined and coarse error energies come within
    ulps of each other after a coarse reset."""
    _check_marshal_against_jax(nb, C, R, False, below_gate=True)


def _check_marshal_against_jax(nb, C, R, events, below_gate):
    B = 4
    inp = chip_smoke.k6_inputs(B, C, R, nb, events, seed=nb + 10 * C,
                               device="cpu", below_gate=below_gate)
    state = cuda_subtractor.unpack(inp["st"])
    offs = inp["offsets"].numpy()
    chain = inp["sf_chain"].numpy()
    P, L = state.refined.H.shape[2], R * 65
    rows = chain[np.arange(B)[:, None, None],
                 offs[:, :, None] + np.arange(P)]  # (B, nb, P, F)
    shape = (B, nb, P, R, 65)
    X = (rows[..., :L] + 1j * rows[..., L:2 * L]).reshape(shape)
    spec = rows[..., 2 * L:3 * L].reshape(shape)
    ev = inp["events"].numpy()

    jcfg = (j_aec3_config.create_default_multichannel_config() if R > 1
            else j_aec3_config.EchoCanceller3Config())
    jstate = _jax_state(j_subt.init_state(jcfg, R, C),
                        apm.state_to_numpy(state))
    want_state, want_outs = jax.vmap(functools.partial(
        j_subt.process_pair, jcfg))(
        jstate, jnp.asarray(X.astype(np.complex64)), jnp.asarray(spec),
        jnp.asarray(inp["ys"].numpy()),
        jnp.asarray(inp["narrow_masks"].numpy()), jnp.asarray(ev[..., 0]),
        jnp.asarray(ev[..., 1]), jnp.zeros((B, nb), bool),
        jnp.asarray(ev[..., 2]),
        jnp.asarray(inp["saturated_capture"].numpy()))

    before = cuda_subtractor.launches
    got_state, got_outs = subtractor_kernel.process_pair_kernel(
        inp["config"], inp["geo"], state, inp["sf_chain"],
        list(inp["offsets"].unbind(1)), list(inp["ys"].unbind(1)),
        list(inp["narrow_masks"].unbind(1)),
        *(list(inp["events"][..., j].unbind(1)) for j in range(3)),
        inp["saturated_capture"])
    assert cuda_subtractor.launches == before
    assert_states_close(apm.state_to_numpy(got_state), flat(want_state),
                        rtol=1e-4)
    for k in range(nb):
        for key in OUT_KEYS:
            w = np.asarray(want_outs[k][key])
            g = got_outs[k][key].numpy()
            assert g.shape == w.shape, (k, key)
            np.testing.assert_allclose(
                g, w, rtol=0, atol=1e-4 * max(float(np.abs(w).max()), 1e-6),
                err_msg=f"block {k} {key}")
        np.testing.assert_array_equal(
            got_outs[k]["refined_current_size"].numpy(),
            np.asarray(want_outs[k]["refined_current_size"]))


def test_apm_with_the_switch_on_equals_it_off_on_the_cpu():
    """48 kHz stereo, B = 2, 5 frames of the echo scene: on the CPU the
    pair-kernel path runs K6's twin on the same windows, so output and
    state are bit-equal to the plain path's, and nothing is launched."""
    render, capture = chip_smoke.echo_scene(5, chip_smoke.SEED, range(2))
    runs = []
    before = cuda_subtractor.launches
    for pair_kernel in (False, True):
        geo = chip_smoke.aec3_geometry("48k_stereo", pair_kernel)
        assert geo.aec3.pair_kernel is pair_kernel
        state = apm.init_state(geo, 2, device="cpu")
        outs = []
        for f in range(5):
            sl = slice(f * 480, (f + 1) * 480)
            state, out, _, _ = apm.process_stream_pair(
                geo, state, torch.from_numpy(capture[:, sl].copy()),
                torch.from_numpy(render[:, sl].copy()))
            outs.append(out.numpy())
        runs.append((np.stack(outs), apm.state_to_numpy(state)))
    assert cuda_subtractor.launches == before
    np.testing.assert_array_equal(runs[1][0], runs[0][0])
    assert_states_close(runs[1][1], runs[0][1], rtol=0,
                        exact=tuple(runs[0][1]))


@pytest.mark.parametrize("value,on", [
    (None, False), ("1", True), ("0", False), ("true", False), ("", False)])
def test_env_switch_turns_on_only_for_1(monkeypatch, value, on):
    """AEC3_PAIR_KERNEL, read by the scripts that follow the JAX package's
    switch (echo_canceller3.py:75-83), turns the kernel on only for exactly
    "1"; the geometry itself takes only its argument, off by default."""
    if value is None:
        monkeypatch.delenv("AEC3_PAIR_KERNEL", raising=False)
    else:
        monkeypatch.setenv("AEC3_PAIR_KERNEL", value)
    assert ec3.pair_kernel_from_env() is on
    assert chip_smoke.aec3_geometry("16k_mono").aec3.pair_kernel is on
    assert ec3.Aec3Geometry.create(ac.EchoCanceller3Config(), 16000, 1,
                                   1).pair_kernel is False
    for explicit in (False, True):
        assert ec3.Aec3Geometry.create(ac.EchoCanceller3Config(), 16000, 1, 1,
                                       pair_kernel=explicit).pair_kernel \
            is explicit
        assert chip_smoke.aec3_geometry(
            "16k_mono", explicit).aec3.pair_kernel is explicit


def test_pair_kernel_rejects_a_coarse_filter_longer_than_the_refined():
    """K6's window holds the refined filter's partitions, so a coarse
    filter longer than the refined one has no route on K6. The geometry
    takes the pair kernel all the same (``supported`` is the JAX twin's
    True), and the echo remover routes those frames to the plain
    ``subtractor.process_pair``, as the JAX twin does
    (echo_remover.py:1049-1054 of the JAX package): 16 kHz mono, B = 2,
    6 frames of the echo scene with a 20-partition coarse filter, K6's
    marshal never called, the output and every leaf of the state equal to
    the plain path's, which is the same code."""
    cfg = ac.EchoCanceller3Config()
    cfg = cfg.replace(filter=dataclasses.replace(
        cfg.filter, coarse=ac.CoarseConfiguration(length_blocks=20)))
    assert subtractor_kernel.supported(cfg)
    render, capture = chip_smoke.echo_scene(6, chip_smoke.SEED, range(2),
                                            rate=16000, channels=1)
    runs = []
    for pair_kernel in (False, True):
        geo = chip_smoke.aec3_geometry("16k_mono", pair_kernel, aec3_cfg=cfg)
        assert geo.aec3.pair_kernel is pair_kernel
        state = apm.init_state(geo, 2, device="cpu")
        assert state.aec.remover.subtractor.coarse.H.shape[2] == 20
        outs = []
        for f in range(6):
            sl = slice(f * 160, (f + 1) * 160)
            state, out, _, _ = apm.process_stream_pair(
                geo, state, torch.from_numpy(capture[:, sl].copy()),
                torch.from_numpy(render[:, sl].copy()))
            outs.append(out.numpy())
        runs.append((np.stack(outs), apm.state_to_numpy(state)))
    np.testing.assert_array_equal(runs[1][0], runs[0][0])
    assert_states_close(runs[1][1], runs[0][1], rtol=0,
                        exact=tuple(runs[0][1]))


def test_long_coarse_filter_never_reaches_the_kernel(monkeypatch):
    """With the pair kernel on and a coarse filter longer than the refined
    one, a frame of the pair path does not call K6's marshal (which would
    launch K6 on the card); with the default filters it does."""
    calls = []
    real = subtractor_kernel.process_pair_kernel

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(subtractor_kernel, "process_pair_kernel", counting)
    render, capture = chip_smoke.echo_scene(1, chip_smoke.SEED, range(1),
                                            rate=16000, channels=1)
    base = ac.EchoCanceller3Config()
    long_coarse = base.replace(filter=dataclasses.replace(
        base.filter, coarse=ac.CoarseConfiguration(length_blocks=20)))
    for cfg, want in ((long_coarse, 0), (base, 1)):
        calls.clear()
        geo = chip_smoke.aec3_geometry("16k_mono", True, aec3_cfg=cfg)
        apm.process_stream_pair(geo, apm.init_state(geo, 1, device="cpu"),
                                torch.from_numpy(capture),
                                torch.from_numpy(render))
        assert len(calls) == want
