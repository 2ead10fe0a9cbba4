"""AECM through the APM against the JAX package's ``process_stream_pair``
on the CPU: the reference's fixed profile (``WEBRTC_AUDIOPROC_FIXED_
PROFILE``: AECM in mobile mode, AGC1 adaptive digital, NS, HPF) at 16 kHz
mono, B = 2 streams of an echo scene (one with a voiced near end) for 30
frames with each package's AGC1 level fed back (tests/torch_aecm_util.py);
the 4 x 4 cascade of 16 cancellers against the JAX package's AECM in its
APM's layout; NS before AECM in the mobile branch.

NS's float rounding reaches AECM's int16 input (ROADMAP Queue 3): a
sample can round to the other int16 some frames after startup, and from
there AECM's state drifts by a few LSBs. So the AECM leaves are held
equal up to the frame where startup exits (every stream's core has run;
tests/test_torch_aecm.py holds AECM alone on every frame), the outputs
and levels on every frame, free running and one step from JAX's own
state."""

import jax
import numpy as np
import pytest
import torch

from webrtc_audio_processing_tpu import apm as j_apm
from webrtc_audio_processing_tpu import config as j_cfg
from webrtc_audio_processing_tpu.models.aecm import (
    echo_control_mobile as j_ecm,
)

from webrtc_audio_processing_tpu_torch import apm
from webrtc_audio_processing_tpu_torch import config as cfg_mod
from webrtc_audio_processing_tpu_torch.models import (
    noise_suppressor as ns_mod,
)
from webrtc_audio_processing_tpu_torch.models.aecm import (
    echo_control_mobile as ecm_mod,
)

from tests.torch_agc1_util import assert_states, t
from tests.torch_aecm_util import RTOL_RMS, rel_rms, run_cases

NAMES = ("fixed_16k",)


@pytest.fixture(scope="module")
def runs():
    return run_cases(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_outputs_match_jax(runs, name):
    """Relative RMS <= 1e-3 per stream free-running over every frame, and
    from JAX's own state one step at a time."""
    r = runs[name]
    assert np.isfinite(np.stack(r["torch"])).all()
    assert (rel_rms(r["torch"], r["jax"]) <= RTOL_RMS).all()
    assert (rel_rms(r["one_step"], r["jax"]) <= RTOL_RMS).all()


@pytest.mark.parametrize("name", NAMES)
def test_aecm_state_matches_jax(runs, name):
    """Every AECM leaf equal on every frame up to the one where the last
    stream leaves startup (its core has run)."""
    r = runs[name]
    exits = r["startup"].index(False)
    assert exits < len(r["startup"]) - 2
    assert all(r["aecm_equal"][:exits + 1]), r["aecm_equal"].index(False)


def test_agc1_level_within_one_every_frame(runs):
    r = runs["fixed_16k"]
    got = np.stack(r["torch_level"]).astype(int)
    want = np.stack(r["jax_level"]).astype(int)
    assert np.abs(got - want).max() <= 1


def test_echo_is_suppressed_after_startup(runs):
    """Stream 0 carries echo only: from frame 20 on the output holds well
    under the echo's energy in both packages."""
    r = runs["fixed_16k"]
    F = 160
    near = r["near"][0, 20 * F:, 0]
    for key in ("torch", "jax"):
        out = np.concatenate([y[0, :, 0] for y in r[key][20:]])
        e_out = np.mean(out ** 2) + 1e-20
        assert 10 * np.log10(np.mean(near ** 2) / e_out) > 8.0


def test_mobile_branch_runs_ns_before_aecm(monkeypatch):
    """NS.Process before AECM and once (audio_processing_impl.cc:
    1393-1405), the render side's far buffering first
    (tests/test_orchestration_seams.py:126)."""
    geo = apm.ApmGeometry.create(
        cfg_mod.Config().replace(
            echo_canceller=cfg_mod.EchoCanceller(enabled=True,
                                                 mobile_mode=True),
            noise_suppression=cfg_mod.NoiseSuppression(enabled=True)),
        16000, 1)
    state = apm.init_state(geo, 2, device="cpu")
    calls = []

    def record(owner, name, tag):
        real = getattr(owner, name)

        def wrapper(*args, **kwargs):
            calls.append(tag)
            return real(*args, **kwargs)
        monkeypatch.setattr(owner, name, wrapper)

    record(ns_mod.NoiseSuppressor, "analyze", "ns.analyze")
    record(ns_mod.NoiseSuppressor, "process", "ns.process")
    record(ecm_mod, "process_frame", "aecm")
    record(ecm_mod, "buffer_farend", "aecm.far")
    x = torch.zeros(2, 160, 1)
    apm.process_stream_pair(geo, state, x, x, stream_delay_ms=0)
    assert calls == ["aecm.far", "ns.analyze", "ns.process", "aecm"], calls


def test_cascade_4x4_matches_jax_aecm_in_its_apm_layout():
    """The 4 x 4 cascade (tests/test_apm_channels_4_8.py:55's geometry): 16
    cancellers, capture major, as the JAX package's apm.py feeds them
    (:529-536: canceller i * 4 + j buffers render channel j; :731-744: one
    stage per render channel j, cancellers (i, j) on capture channel i's
    band as the stage before left it), its ``echo_control_mobile``
    functions against the port's ``apm.buffer_aecm_far_end`` and
    ``apm.process_aecm``, B = 1 for 12 frames of distinct channels: every
    output and state leaf bit for bit."""
    C, F, n_frames = 4, 160, 12

    def cfg(m):
        return m.Config().replace(
            pipeline=m.Pipeline(multi_channel_capture=True,
                                multi_channel_render=True),
            echo_canceller=m.EchoCanceller(enabled=True, mobile_mode=True),
            noise_suppression=m.NoiseSuppression(enabled=True))

    jgeo = j_apm.ApmGeometry.create(cfg(j_cfg), 16000, C,
                                    num_render_channels=C)
    geo = apm.ApmGeometry.create(cfg(cfg_mod), 16000, C,
                                 num_render_channels=C)
    js = jax.tree_util.tree_map(np.array, j_apm._init_aecm_states(jgeo))
    ps = apm.init_state(geo, 1, device="cpu").aecm
    assert ps.far_written.shape == (1, C * C)
    jbuf = jax.jit(jax.vmap(j_ecm.buffer_farend))
    jproc = jax.jit(jax.vmap(lambda s, x, d: j_ecm.process_frame(
        jgeo.aecm, s, x, 0, d)))
    rng = np.random.default_rng(44)
    tt = np.arange(n_frames * F) / 16000
    burst = (np.sin(2 * np.pi * 2.7 * tt) > -0.3)
    far = (rng.normal(size=(n_frames * F, C)) * 9000 * burst[:, None]).clip(
        -30000, 30000).astype(np.int32)
    near = (0.5 * np.roll(far, 400, 0) + 0.3 * np.roll(far[:, ::-1], 480, 0)
            + 50 * rng.normal(size=far.shape)).astype(np.int32)
    delay = np.zeros(C, np.int32)
    for f in range(n_frames):
        fr, x = far[f * F:(f + 1) * F], near[f * F:(f + 1) * F]
        js = jax.tree_util.tree_map(
            np.array, jbuf(js, np.tile(fr.T, (C, 1))))
        y = x.T
        for j in range(C):
            idx = np.arange(C) * C + j
            st, y = jproc(jax.tree_util.tree_map(lambda a: a[idx], js), y,
                          delay)
            y = np.asarray(y)

            def put(a, b, idx=idx):
                a[idx] = np.asarray(b)
                return a
            js = jax.tree_util.tree_map(put, js, st)
        ps = apm.buffer_aecm_far_end(
            ps, t(fr.astype(np.float32))[None, None])
        ps, bands = apm.process_aecm(
            geo.aecm, ps, t(x.astype(np.float32))[None, None], 0)
        np.testing.assert_array_equal(bands[0, 0].numpy(), y.T,
                                      err_msg=f"frame {f}")
    assert_states(ps, jax.tree_util.tree_map(lambda a: a[None], js))
    assert not js.ec_startup.any()
