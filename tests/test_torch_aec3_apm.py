"""The closed main path against the JAX package on the CPU:
``apm.process_stream_pair`` at 48 kHz stereo with HPF, multichannel AEC3,
NS and AGC2 (the bench's configuration, bench.py:53-78), B = 2 streams of
the echo scene for 20 frames. One module-scoped run of each package serves
every test; the JAX step compiles once per frame parity, the two parities
side by side."""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webrtc_audio_processing_tpu import apm as j_apm

from webrtc_audio_processing_tpu_torch import apm
from webrtc_audio_processing_tpu_torch.ops import (
    cuda_biquad,
    cuda_matched_filter,
    cuda_pre_echo,
    cuda_span,
    cuda_window,
)

from tests.torch_aec3_setup import (
    assert_states_close,
    batched,
    echo_scene,
    flat,
    geometries,
)

B = 2
N_FRAMES = 20
STATE_FRAME = 2  # the state is compared after this frame


@pytest.fixture(scope="module")
def runs():
    """Both packages on the same inputs from the same initial state."""
    jgeo, geo = geometries()
    renders, captures = echo_scene(N_FRAMES, B, seed=3)
    js = batched(j_apm.init_state(jgeo), B)

    def compiled(parity):
        step = jax.jit(jax.vmap(
            lambda s, c, r, n0: j_apm.process_stream_pair(
                jgeo, s, c, r, parity, n0=n0), in_axes=(0, 0, 0, None)))
        return step.lower(js, captures[0], renders[0], jnp.int32(0)).compile()

    # The two frame parities compile side by side (each is minutes of
    # single-threaded XLA work on the CPU).
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        steps = list(pool.map(compiled, (0, 1)))
    state = apm.state_from_jax(js, geo)
    launches = [m.launches for m in (cuda_biquad, cuda_span,
                                     cuda_matched_filter, cuda_pre_echo,
                                     cuda_window)]
    out = {"jax": [], "torch": [], "jax_delay": [], "torch_delay": [],
           "jax_render": [], "torch_render": []}
    for f in range(N_FRAMES):
        n0 = 5 * (f // 2) + 2 * (f % 2)
        js, jy, jr, jstats = steps[f % 2](js, captures[f], renders[f],
                                          jnp.int32(n0))
        js = jax.tree_util.tree_map(np.asarray, js)
        state, y, r, stats = apm.process_stream_pair(
            geo, state, torch.from_numpy(captures[f]),
            torch.from_numpy(renders[f]))
        out["jax"].append(np.asarray(jy))
        out["torch"].append(y.numpy())
        out["jax_render"].append(np.asarray(jr))
        out["torch_render"].append(r.numpy())
        out["jax_delay"].append(np.asarray(jstats["delay_ms"]))
        out["torch_delay"].append(stats["delay_ms"].numpy())
        if f == STATE_FRAME:
            # The JAX state with the ordinal of the next frame beside it.
            out["jax_state"] = {**flat(js), "aec3_block_ordinal": np.asarray(
                5 * ((f + 1) // 2) + 2 * ((f + 1) % 2), np.int32)}
            out["torch_state"] = apm.state_to_numpy(state)
    out["jax_stats"] = jax.tree_util.tree_map(np.asarray, jstats)
    out["torch_stats"] = {k: v.numpy() for k, v in stats.items()}
    out["launches"] = [m.launches - b for m, b in zip(
        (cuda_biquad, cuda_span, cuda_matched_filter, cuda_pre_echo,
         cuda_window), launches)]
    out["frame_counter"] = state.frame_counter
    return out


def test_output_matches_jax_within_relative_rms(runs):
    """Relative RMS <= 1e-3 per stream over the 20 frames (the BASELINE.md
    bar); the render output within float rounding."""
    got, want = np.stack(runs["torch"]), np.stack(runs["jax"])
    err = ((got - want) ** 2).sum(axis=(0, 2, 3))
    ref = (want ** 2).sum(axis=(0, 2, 3))
    rel = np.sqrt(err / ref)
    assert (rel <= 1e-3).all(), rel
    np.testing.assert_allclose(np.stack(runs["torch_render"]),
                               np.stack(runs["jax_render"]), rtol=0,
                               atol=1e-6)
    assert np.isfinite(got).all()


def test_delay_ms_equal_on_every_frame(runs):
    np.testing.assert_array_equal(np.stack(runs["torch_delay"]),
                                  np.stack(runs["jax_delay"]))


def test_state_after_frame_2_leaf_by_leaf(runs):
    """Every leaf of the APM state, AEC3 included: integer and boolean
    leaves exact, float leaves within 1e-4 of each leaf's scale."""
    assert_states_close(runs["torch_state"], runs["jax_state"], rtol=1e-4)


def test_stats_keys_and_values_match_jax(runs):
    """The same stats keys as the JAX step; flags and counts equal, float
    stats within 1e-4 of their scale."""
    want, got = runs["jax_stats"], runs["torch_stats"]
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if w.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            scale = max(float(np.abs(w).max()), 1e-6)
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * scale,
                                       err_msg=k)


def test_cpu_run_takes_the_twins(runs):
    """On the CPU no kernel launches; the frame counter advanced once per
    step."""
    assert runs["launches"] == [0, 0, 0, 0, 0]
    assert runs["frame_counter"] == N_FRAMES
