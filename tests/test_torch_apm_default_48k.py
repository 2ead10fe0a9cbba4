"""The APM's default pipeline at 48 kHz stereo against the JAX package on
the CPU: ``Config()``'s own ``Pipeline()`` (internal rate capped at
32 kHz, multichannel capture and render off) with HPF, AEC3, NS and AGC2
(``chip_smoke.aec3_config(.., "default_48k")``), so the AudioBuffer
resamples 48 -> 32 kHz and back, the capture is split into two bands by
the QMF and narrowed to mono, the stereo render is downmixed into a mono
buffer, and no PostFilter runs. B = 2 streams of ``chip_smoke.echo_scene``
for 12 frames; one module-scoped run of each package serves every test,
the JAX step compiled once per frame parity, side by side."""

import concurrent.futures
import contextlib

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

from tests.torch_aec3_setup import assert_states_close, batched, flat

B = 2
N_FRAMES = 12
STATE_FRAME = 2  # the state is compared after this frame
RATE = 48000
FRAME = RATE // 100
MODE = "default_48k"
# The kernel wrappers' entry points, counted on the CPU (where no kernel
# launches) against the launches chip_smoke.py expects on the card.
WRAPPERS = {"biquad_cascade": "cascade", "span_gather": "span_gather",
            "matched_filter_nlms": "nlms", "pre_echo_inst": "pre_echo_inst",
            "take_windows": "take_windows", "subtractor_pair": "pair",
            "agc1_limiter": "limit"}


def geometry(m):
    """The default pipeline's geometry of package ``m``'s apm and config."""
    pkg_apm, pkg_cfg = m
    return pkg_apm.ApmGeometry.create(
        chip_smoke.aec3_config(pkg_cfg, MODE), RATE, 2,
        render_input_rate=RATE, num_render_channels=2)


@contextlib.contextmanager
def counting_wrappers(calls):
    """Count the calls of each kernel wrapper while the block runs."""
    saved = []
    counters = chip_smoke._kernel_counters()
    for name, fn in WRAPPERS.items():
        mod = counters[name][0]
        orig = getattr(mod, fn)

        def spy(*args, _orig=orig, _name=name, **kw):
            calls[_name] += 1
            return _orig(*args, **kw)

        saved.append((mod, fn, orig))
        setattr(mod, fn, spy)
    try:
        yield calls
    finally:
        for mod, fn, orig in saved:
            setattr(mod, fn, orig)


@pytest.fixture(scope="module")
def runs():
    """Both packages on the same inputs from the same initial state."""
    jgeo, geo = geometry((j_apm, j_cfg)), geometry((apm, cfg_mod))
    render, capture = chip_smoke.echo_scene(N_FRAMES, seed=5,
                                            streams=range(B), rate=RATE,
                                            channels=2)

    def frames(x):
        return np.ascontiguousarray(
            x.reshape(B, N_FRAMES, FRAME, 2).transpose(1, 0, 2, 3))

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
           "jax_render": [], "torch_render": [],
           "calls": {k: 0 for k in WRAPPERS}}
    for f in range(N_FRAMES):
        n0 = apm.block_ordinal(f)
        js, jy, jr, jstats = steps[f % 2](js, captures[f], renders[f],
                                          jnp.int32(n0))
        js = jax.tree_util.tree_map(np.asarray, js)
        with counting_wrappers(out["calls"]):
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
                apm.block_ordinal(f + 1), np.int32)}
            out["torch_state"] = apm.state_to_numpy(state)
    out["jax_stats"] = jax.tree_util.tree_map(np.asarray, jstats)
    out["torch_stats"] = {k: v.numpy() for k, v in stats.items()}
    out["geo"] = geo
    return out


def test_geometry_is_the_default_pipeline():
    """Processing at 32 kHz in two bands, mono capture after the split, a
    mono render buffer, mono AEC3 with the plain subtractor, no
    PostFilter, the full-band HPF on both capture channels with the 48 kHz
    table (the reference's pairing below a 48 kHz output)."""
    geo = geometry((apm, cfg_mod))
    assert geo.config.pipeline == cfg_mod.Pipeline()
    assert (geo.capture_processing_rate, geo.render_processing_rate) == (
        32000, 32000)
    assert geo.capture_processing_channels == 1
    assert geo.render_processing_channels == 1
    assert geo.aec3.num_bands == 2 and not geo.aec3.pair_kernel
    assert (geo.aec3.num_capture_channels,
            geo.aec3.num_render_channels) == (1, 1)
    assert not geo.post_filter_enabled
    assert geo.hpf_full_band and geo.hpf_rate == 48000
    assert geo.hpf_channels == 2
    cb, rb = geo.capture_buffer_config(), geo.render_buffer_config()
    assert cb.input_resampling and cb.output_resampling and cb.num_bands == 2
    assert (rb.input_num_channels, rb.buffer_num_channels) == (2, 1)


def test_output_matches_jax_within_relative_rms(runs):
    """Relative RMS <= 1e-3 per stream over the frames (the BASELINE.md
    bar), for the capture output and the render output."""
    for which in ("", "_render"):
        got = np.stack(runs["torch" + which])
        want = np.stack(runs["jax" + which])
        assert got.shape == (N_FRAMES, B, FRAME, 2)
        err = ((got - want) ** 2).sum(axis=(0, 2, 3))
        ref = (want ** 2).sum(axis=(0, 2, 3))
        assert (np.sqrt(err / ref) <= 1e-3).all(), (which,
                                                    np.sqrt(err / ref))
        assert np.isfinite(got).all()


def test_delay_ms_equal_on_every_frame(runs):
    np.testing.assert_array_equal(np.stack(runs["torch_delay"]),
                                  np.stack(runs["jax_delay"]))


def test_state_after_frame_2_leaf_by_leaf(runs):
    """Every leaf of the APM state, the resamplers' buffers and both QMF
    directions' states included: integer and boolean leaves exact, float
    leaves within 1e-4 of each leaf's scale."""
    got = runs["torch_state"]
    for leaf in ("capture_buffer.input_resampler",
                 "capture_buffer.output_resampler",
                 "render_buffer.split.synthesis.state1",
                 "capture_buffer.split.analysis.state2"):
        assert leaf in got
    assert_states_close(got, runs["jax_state"], rtol=1e-4)


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


def test_kernel_wrappers_called_as_chip_smoke_expects(runs):
    """Each wrapper is called as often as ``expected_aec3_launches`` says
    the card launches it: K1 9 times a frame (the HPF, four QMF directions
    of two cascades) plus the decimations, no PostFilter, no K6."""
    want = chip_smoke.expected_aec3_launches(runs["geo"], N_FRAMES)
    # K2's bf16 form shares span_gather's wrapper; float32 rings here.
    assert want.pop("span_gather_bf16") == 0
    assert runs["calls"] == want
    assert want["biquad_cascade"] == 9 * N_FRAMES + 2 * 30
