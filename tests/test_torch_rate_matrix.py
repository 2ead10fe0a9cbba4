"""The rate and channel matrix of the desktop pipeline against the JAX
package on the CPU, one parametrised test over the 20 cases of
``tests/torch_rate_matrix.py``: B = 2 streams for 8 frames, the JAX step
compiled once per frame parity for each case (side by side), so the set
takes minutes and is marked slow:

    python -m pytest tests/test_torch_rate_matrix.py -m slow -n 4

Each case holds the checks of ``tests/test_torch_apm_default_48k.py``:
capture and render output within a relative RMS of 1e-3 per stream, the
delay equal on every frame, every state leaf after frame 2 (integer and
boolean leaves exactly, float leaves within 1e-4 of each leaf's scale but
the RNN-VAD's pitch strength, within 1e-3), and the stats' keys, shapes
and values."""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webrtc_audio_processing_tpu import apm as j_apm
from webrtc_audio_processing_tpu import config as j_cfg

from webrtc_audio_processing_tpu_torch import apm
from webrtc_audio_processing_tpu_torch import config as cfg_mod

from tests import torch_rate_matrix as matrix
from tests.torch_aec3_setup import assert_states_close, batched, flat

B = 2
N_FRAMES = 8
STATE_FRAME = 2


def _rel_rms(got, want):
    err = ((got - want) ** 2).sum(axis=(0, 2, 3))
    return np.sqrt(err / np.maximum((want ** 2).sum(axis=(0, 2, 3)), 1e-30))


@pytest.mark.slow
@pytest.mark.parametrize("case", sorted(matrix.CASES))
def test_matrix_case_matches_jax(case):
    rate, cap, ren, _ = matrix.CASES[case]
    jgeo = matrix.geometry(j_apm, j_cfg, case)
    geo = matrix.geometry(apm, cfg_mod, case)
    renders, captures = matrix.scene(case, N_FRAMES, B, seed=7)
    js = batched(j_apm.init_state(jgeo), B)

    def compiled(parity):
        step = jax.jit(jax.vmap(
            lambda s, c, r, n0: j_apm.process_stream_pair(
                jgeo, s, c, r, parity, n0=n0), in_axes=(0, 0, 0, None)))
        return step.lower(js, captures[0], renders[0], jnp.int32(0)).compile()

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        steps = list(pool.map(compiled, (0, 1)))
    state = apm.state_from_jax(js, geo)
    outs = {k: [] for k in ("jax", "torch", "jax_r", "torch_r", "jax_d",
                            "torch_d")}
    for f in range(N_FRAMES):
        js, jy, jr, jstats = steps[f % 2](js, captures[f], renders[f],
                                          jnp.int32(apm.block_ordinal(f)))
        js = jax.tree_util.tree_map(np.asarray, js)
        state, y, r, stats = apm.process_stream_pair(
            geo, state, torch.from_numpy(captures[f]),
            torch.from_numpy(renders[f]))
        for k, v in (("jax", jy), ("torch", y), ("jax_r", jr),
                     ("torch_r", r), ("jax_d", jstats["delay_ms"]),
                     ("torch_d", stats["delay_ms"])):
            outs[k].append(np.asarray(v))
        if f == STATE_FRAME:
            want_state = {**flat(js), "aec3_block_ordinal": np.asarray(
                apm.block_ordinal(f + 1), np.int32)}
            got_state = apm.state_to_numpy(state)

    got, want = np.stack(outs["torch"]), np.stack(outs["jax"])
    assert got.shape == (N_FRAMES, B, rate // 100, cap)
    assert np.isfinite(got).all()
    assert (_rel_rms(got, want) <= 1e-3).all(), _rel_rms(got, want)
    got_r, want_r = np.stack(outs["torch_r"]), np.stack(outs["jax_r"])
    assert got_r.shape == (N_FRAMES, B, rate // 100, ren)
    assert (_rel_rms(got_r, want_r) <= 1e-3).all(), _rel_rms(got_r, want_r)
    np.testing.assert_array_equal(np.stack(outs["torch_d"]),
                                  np.stack(outs["jax_d"]))
    # The RNN-VAD's pitch strength is a normalised correlation over a pitch
    # buffer still mostly empty at frame 2: last-bit differences in NS's
    # output (torch.fft against XLA's FFT; output relative RMS 1.5e-7) move
    # it by up to 1.01e-4 of its scale (8k_c1_r1). It is held to 1e-3,
    # every other leaf to 1e-4.
    loose = "agc2.vad.features.last_pitch_strength"
    assert_states_close({k: v for k, v in got_state.items() if k != loose},
                        {k: v for k, v in want_state.items() if k != loose},
                        rtol=1e-4)
    assert_states_close({loose: got_state[loose]},
                        {loose: want_state[loose]}, rtol=1e-3)
    jstats = jax.tree_util.tree_map(np.asarray, jstats)
    assert set(stats) == set(jstats)
    for k, w in jstats.items():
        g = stats[k].numpy()
        assert g.shape == w.shape, k
        if w.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            scale = max(float(np.abs(w).max()), 1e-6)
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * scale,
                                       err_msg=k)
    if ren > 1 and geo.aec3.num_render_channels == 1:
        # The downmix ran both ways: channel 0 in stream 0, the mean in 1.
        assert state.aec.mc_detector.temporary_detected.tolist() == [
            False, True]
