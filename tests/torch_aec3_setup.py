"""Shared set-up of the AEC3 parity tests (tests/test_torch_aec3_*.py): the
bench's 48 kHz stereo configuration on both packages, the echo scene, and
pytree helpers. Everything is made from seeds with numpy."""

import jax
import numpy as np
import torch

from tests import torch_threads  # noqa: F401  (one thread a worker)
import chip_smoke

from webrtc_audio_processing_tpu import apm as j_apm
from webrtc_audio_processing_tpu import config as j_cfg

from webrtc_audio_processing_tpu_torch import apm
from webrtc_audio_processing_tpu_torch import config as cfg_mod

FS = 48000


def bench_config(m):
    """``bench.build_step``'s 48 kHz stereo configuration (bench.py:53-78)
    in package ``m``'s config classes."""
    return m.Config().replace(
        pipeline=m.Pipeline(multi_channel_capture=True,
                            multi_channel_render=True,
                            maximum_internal_processing_rate=48000),
        high_pass_filter=m.HighPassFilter(enabled=True),
        echo_canceller=m.EchoCanceller(enabled=True),
        noise_suppression=m.NoiseSuppression(enabled=True),
        gain_controller2=m.GainController2(
            enabled=True, adaptive_digital=m.AdaptiveDigital(enabled=True)),
    )


def geometries():
    """(JAX geometry, port geometry) of the bench configuration."""
    kw = dict(render_input_rate=FS, num_render_channels=2,
              aec3_stereo_content=True)
    return (j_apm.ApmGeometry.create(bench_config(j_cfg), FS, 2, **kw),
            apm.ApmGeometry.create(bench_config(cfg_mod), FS, 2, **kw))


def echo_scene(n_frames, batch, seed):
    """``chip_smoke.echo_scene`` for streams 0..batch-1 as frames: (render,
    capture), each (n_frames, B, 480, 2) float32 in [-1, 1]."""
    render, capture = chip_smoke.echo_scene(n_frames, seed, range(batch))

    def frames(x):
        return np.ascontiguousarray(
            x.reshape(batch, n_frames, 480, 2).transpose(1, 0, 2, 3))

    return frames(render), frames(capture)


def batched(tree, batch):
    """A per-stream JAX pytree repeated over a leading batch axis, as numpy
    (numpy leaves carry no weak types, so jitted steps compile once)."""
    return jax.tree_util.tree_map(
        lambda a: np.broadcast_to(np.asarray(a), (batch,) + np.shape(a)).copy(),
        tree)


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def flat(tree) -> dict:
    """{dotted path: numpy leaf} of a JAX pytree."""
    return {jax.tree_util.keystr(p)[1:]: np.asarray(leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_states_close(got: dict, want: dict, rtol: float, exact=()):
    """Leaf by leaf: integer and boolean leaves exactly, float leaves
    within ``rtol`` of each leaf's largest magnitude; leaves whose path
    starts with one of ``exact`` bit for bit."""
    assert set(got) == set(want), set(got) ^ set(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if w.dtype.kind in "iub" or k.startswith(tuple(exact)):
            np.testing.assert_array_equal(g, w, err_msg=k)
        elif w.size:
            scale = max(float(np.abs(w).max()), 1e-6)
            np.testing.assert_allclose(g, w, rtol=0, atol=rtol * scale,
                                       err_msg=k)


def torch_tree(template, tree):
    """The port's state dataclass ``template`` filled from a batch-first
    JAX pytree."""
    return apm.tree_to_state(template, to_numpy(tree))


def t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def ordinal(n):
    """AEC3's block ordinal as the port takes it: a 0-d int32 tensor."""
    return torch.tensor(n, dtype=torch.int32)


# ------------------------------------- AEC3 alone, one band, JAX beside it


def mono_scene(n_frames, batch, seed, rate=16000, delay=0):
    """``chip_smoke.echo_scene`` at ``rate`` mono for streams 0..batch-1 as
    AEC3 frames, the echo ``delay`` samples late (the render moved on by
    that much): (render, capture), each (n_frames, B, 1 band, rate // 100,
    1) in floatS16."""
    frame = rate // 100
    extra = -(-delay // frame)
    render, capture = chip_smoke.echo_scene(n_frames + extra, seed,
                                            range(batch), rate=rate,
                                            channels=1)
    n = n_frames * frame
    render, capture = render[:, delay:delay + n], capture[:, :n]

    def frames(x):
        x = x.reshape(batch, n_frames, frame, 1).transpose(1, 0, 2, 3)
        return np.ascontiguousarray(x[:, :, None] * 32768.0,
                                    dtype=np.float32)

    return frames(render), frames(capture)


def _compile_aec3_step(jgeo, parity):
    """``echo_canceller3.process_frame`` of the JAX package for one stream
    of ``jgeo`` at frame ``parity``, jitted and compiled (a batch of one
    would compile the same program at twice the cost under vmap)."""
    import jax.numpy as jnp

    from webrtc_audio_processing_tpu.models.aec3 import (
        echo_canceller3 as j_ec3,
    )

    r = np.zeros((jgeo.num_bands, 160, jgeo.num_render_channels), np.float32)
    c = np.zeros((jgeo.num_bands, 160, jgeo.num_capture_channels),
                 np.float32)
    step = jax.jit(lambda s, r, c, n0: j_ec3.process_frame(
        jgeo, s, r, c, parity, n0=n0))
    return step.lower(j_ec3.init_state(jgeo), r, c, jnp.int32(0)).compile()


def stack(trees):
    return jax.tree_util.tree_map(lambda *a: np.stack(a), *trees)


def run_aec3_both(jgeo, geo, renders, captures, state_frames=()):
    """Every frame of ``renders`` / ``captures`` through both packages from
    the same initial state: the JAX package's ``process_frame`` one stream
    at a time (its two frame parities compile side by side, in threads,
    while the port runs), the port batched. Returns {"jax", "torch":
    outputs (frames, B, ...), "jax_delay", "torch_delay": the delay
    estimator's delay in samples (frames, B), "jax_state" / "torch_state":
    {frame: flattened state} after each frame of ``state_frames``,
    "jax_tree": {frame: the JAX pytree}}."""
    import concurrent.futures

    import jax.numpy as jnp

    from webrtc_audio_processing_tpu.models.aec3 import (
        echo_canceller3 as j_ec3,
    )
    from webrtc_audio_processing_tpu_torch.models.aec3 import (
        echo_canceller3 as ec3,
    )

    B, n_frames = renders.shape[1], renders.shape[0]
    init = [to_numpy(j_ec3.init_state(jgeo)) for _ in range(B)]
    out = {"jax": [], "torch": [], "jax_delay": [], "torch_delay": [],
           "jax_state": {}, "torch_state": {}, "jax_tree": {}}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        steps = [pool.submit(_compile_aec3_step, jgeo, p) for p in (0, 1)]
        state = torch_tree(ec3.init_state(geo, B, "cpu"), stack(init))
        for f in range(n_frames):
            state, y, _ = ec3.process_frame(
                geo, state, t(renders[f]), t(captures[f]), f % 2,
                ordinal(apm.block_ordinal(f)))[:3]
            out["torch"].append(y.numpy())
            out["torch_delay"].append(state.delay.delay_samples.numpy())
            if f in state_frames:
                out["torch_state"][f] = apm.state_to_numpy(state)
        steps = [s.result() for s in steps]
    jstates = init
    for f in range(n_frames):
        n0 = jnp.int32(apm.block_ordinal(f))
        outs = [steps[f % 2](jstates[b], renders[f, b], captures[f, b], n0)
                for b in range(B)]
        jstates = [to_numpy(o[0]) for o in outs]
        js = stack(jstates)
        out["jax"].append(np.stack([np.asarray(o[1]) for o in outs]))
        out["jax_delay"].append(js.delay.delay_samples)
        if f in state_frames:
            out["jax_state"][f] = flat(js)
            out["jax_tree"][f] = js
    for k in ("jax", "torch", "jax_delay", "torch_delay"):
        out[k] = np.stack(out[k])
    return out


def rel_rms_per_stream(got, want):
    """Relative RMS per stream of (frames, B, ...) arrays."""
    axes = (0,) + tuple(range(2, got.ndim))
    err = np.sqrt(((got - want) ** 2).sum(axis=axes))
    return err / np.maximum(np.sqrt((want ** 2).sum(axis=axes)), 1.0)
