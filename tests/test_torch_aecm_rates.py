"""AECM through the APM at the other rates, against the JAX package's
``process_stream_pair`` on the CPU: the reference's fixed profile
(tests/torch_aecm_util.py) at 32 kHz, where AECM runs on band 0 and zeroes
band 1, and at 8 kHz, where the capture is processed at 16 kHz and so is
AECM; the pair body at 8 kHz against plain steps."""

import numpy as np
import pytest
import torch

from webrtc_audio_processing_tpu import apm as j_apm

from webrtc_audio_processing_tpu_torch import apm, step_graph

from tests.torch_agc1_util import t
from tests.torch_aecm_util import (
    RTOL_RMS,
    geometry,
    rel_rms,
    run_cases,
    scene,
)

NAMES = ("fixed_32k", "fixed_8k")


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


def test_32k_upper_band_is_zeroed():
    """At 32 kHz the APM splits two bands and AECM zeroes band 1
    (echo_control_mobile_impl.cc:219-224): a 10 kHz tone, all in the upper
    band, leaves the output (tests/test_aecm_apm.py:52)."""
    geo = geometry(apm, "fixed_32k")
    state = apm.init_state(geo, 1, device="cpu")
    n = 32000 // 5
    x = (0.3 * np.sin(2 * np.pi * 10000 * np.arange(n) / 32000)).astype(
        np.float32)
    outs = []
    for f in range(n // 320):
        state, y, _, _ = apm.process_stream_pair(
            geo, state, t(x[None, f * 320:(f + 1) * 320, None]),
            torch.zeros(1, 320, 1))
        outs.append(y[0, :, 0].numpy())
    out = np.concatenate(outs)[n // 2:]
    assert np.mean(out ** 2) < 0.01 * np.mean(x[n // 2:] ** 2)


def test_8k_runs_aecm_at_16k_and_pair_body_equals_plain_steps(runs):
    """At 8 kHz the capture is processed at 16 kHz (SuitableProcessRate),
    so AECM runs at 16 kHz and the period is AEC3's 2 in both packages
    (AECM's rebuffering phase is state). Four pairs of
    ``step_graph.step_pair`` from init against eight plain steps: every
    output, stat and state leaf bit for bit, the delay an input."""
    geo = runs["fixed_8k"]["geo"]
    jgeo = geometry(j_apm, "fixed_8k")
    assert geo.aecm.sample_rate_hz == jgeo.aecm.sample_rate_hz == 16000
    assert apm.parity_period(geo) == 2
    far, near = scene("fixed_8k")
    delay = torch.tensor([30, 30], dtype=torch.int32)
    owned = apm.init_state(geo, 2, device="cpu")
    plain = apm.init_state(geo, 2, device="cpu")
    F = 80
    for p in range(4):
        frames = [(t(far[:, f * F:(f + 1) * F]), t(near[:, f * F:(f + 1) * F]))
                  for f in (2 * p, 2 * p + 1)]
        outs = step_graph.step_pair(geo, owned, *frames[0], *frames[1],
                                    delay=delay)
        for (out, rout, stats), (r, c) in zip(outs, frames):
            plain, p_out, p_rout, p_stats = apm.process_stream_pair(
                geo, plain, c, r, stream_delay_ms=delay)
            assert torch.equal(out, p_out) and torch.equal(rout, p_rout)
            for k, v in p_stats.items():
                assert torch.equal(stats[k], v), k
    got, want = apm.state_to_numpy(owned), apm.state_to_numpy(plain)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)


