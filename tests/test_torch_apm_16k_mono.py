"""The bench's 16 kHz mono configuration against the JAX package on the CPU:
``apm.process_stream_pair`` at 16 kHz, one capture and one render channel,
with HPF, AEC3, NS and AGC2 (``bench.py`` mode ``16k_mono``, bench.py:33 and
:53-78), B = 2 streams of a mono echo scene for 12 frames. One
module-scoped run of each package serves every test; the JAX step compiles
once per frame parity."""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke

from webrtc_audio_processing_tpu import apm as j_apm
from webrtc_audio_processing_tpu import config as j_cfg

from webrtc_audio_processing_tpu_torch import apm
from webrtc_audio_processing_tpu_torch import config as cfg_mod
from webrtc_audio_processing_tpu_torch.ops import cuda_subtractor

from tests.torch_aec3_setup import assert_states_close, batched, flat

B = 2
N_FRAMES = 12
STATE_FRAME = 2  # the state is compared after this frame
RATE = 16000
FRAME = RATE // 100


def geometry(m):
    """The 16 kHz mono geometry of package ``m``'s apm and config."""
    pkg_apm, pkg_cfg = m
    return pkg_apm.ApmGeometry.create(
        chip_smoke.aec3_config(pkg_cfg, "16k_mono"), RATE, 1,
        render_input_rate=RATE, num_render_channels=1)


@pytest.fixture(scope="module")
def runs():
    """Both packages on the same inputs from the same initial state."""
    jgeo, geo = geometry((j_apm, j_cfg)), geometry((apm, cfg_mod))
    render, capture = chip_smoke.echo_scene(N_FRAMES, seed=5,
                                            streams=range(B), rate=RATE,
                                            channels=1)

    def frames(x):
        return np.ascontiguousarray(
            x.reshape(B, N_FRAMES, FRAME, 1).transpose(1, 0, 2, 3))

    renders, captures = frames(render), frames(capture)
    js = batched(j_apm.init_state(jgeo), B)

    def compiled(parity):
        step = jax.jit(jax.vmap(
            lambda s, c, r, n0: j_apm.process_stream_pair(
                jgeo, s, c, r, parity, n0=n0), in_axes=(0, 0, 0, None)))
        return step.lower(js, captures[0], renders[0], jnp.int32(0)).compile()

    # The two frame parities compile side by side.
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        steps = list(pool.map(compiled, (0, 1)))
    state = apm.state_from_jax(js, geo)
    out = {"jax": [], "torch": [], "jax_delay": [], "torch_delay": [],
           "init": js, "captures": captures, "renders": renders}
    for f in range(N_FRAMES):
        n0 = 5 * (f // 2) + 2 * (f % 2)
        js, jy, _, jstats = steps[f % 2](js, captures[f], renders[f],
                                         jnp.int32(n0))
        js = jax.tree_util.tree_map(np.asarray, js)
        state, y, _, stats = apm.process_stream_pair(
            geo, state, torch.from_numpy(captures[f]),
            torch.from_numpy(renders[f]))
        out["jax"].append(np.asarray(jy))
        out["torch"].append(y.numpy())
        out["jax_delay"].append(np.asarray(jstats["delay_ms"]))
        out["torch_delay"].append(stats["delay_ms"].numpy())
        if f == STATE_FRAME:
            # The JAX state with the ordinal of the next frame beside it.
            out["jax_state"] = {**flat(js), "aec3_block_ordinal": np.asarray(
                5 * ((f + 1) // 2) + 2 * ((f + 1) % 2), np.int32)}
            out["torch_state"] = apm.state_to_numpy(state)
    out["jax_stats"] = jax.tree_util.tree_map(np.asarray, jstats)
    out["torch_stats"] = {k: v.numpy() for k, v in stats.items()}
    out["geo"] = geo
    return out


def test_geometry_is_the_bench_mode(runs):
    """One band at 16 kHz, mono AEC3 with refined and coarse filters of 13
    partitions, no PostFilter."""
    geo = runs["geo"]
    assert geo.capture_processing_rate == RATE and geo.aec3.num_bands == 1
    assert (geo.aec3.num_capture_channels,
            geo.aec3.num_render_channels) == (1, 1)
    assert not geo.post_filter_enabled
    f = geo.aec3.config.filter
    assert f.refined.length_blocks == f.coarse.length_blocks == 13


def test_output_matches_jax_within_relative_rms(runs):
    """Relative RMS <= 1e-3 per stream over the frames (the BASELINE.md
    bar)."""
    got, want = np.stack(runs["torch"]), np.stack(runs["jax"])
    err = ((got - want) ** 2).sum(axis=(0, 2, 3))
    ref = (want ** 2).sum(axis=(0, 2, 3))
    assert (np.sqrt(err / ref) <= 1e-3).all(), np.sqrt(err / ref)
    assert np.isfinite(got).all()


def test_delay_ms_equal_on_every_frame(runs):
    np.testing.assert_array_equal(np.stack(runs["torch_delay"]),
                                  np.stack(runs["jax_delay"]))


def test_state_after_frame_2_leaf_by_leaf(runs):
    """Every leaf of the APM state, AEC3 included: integer and boolean
    leaves exact, float leaves within 1e-4 of each leaf's scale."""
    assert_states_close(runs["torch_state"], runs["jax_state"], rtol=1e-4)


def test_stats_keys_and_values_match_jax(runs):
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


def test_pair_kernel_path_equals_the_plain_one_on_the_cpu(runs):
    """The same frames with the subtractor on K6 (its twin, on the CPU):
    bit-equal output, no launch."""
    geo = apm.ApmGeometry.create(
        chip_smoke.aec3_config(cfg_mod, "16k_mono"), RATE, 1,
        render_input_rate=RATE, num_render_channels=1, aec3_pair_kernel=True)
    state = apm.state_from_jax(runs["init"], geo)
    before = cuda_subtractor.launches
    for f in range(N_FRAMES):
        state, y, _, _ = apm.process_stream_pair(
            geo, state, torch.from_numpy(runs["captures"][f]),
            torch.from_numpy(runs["renders"][f]))
        np.testing.assert_array_equal(y.numpy(), runs["torch"][f])
    assert cuda_subtractor.launches == before
