"""Shared set-up of the AEC3 parity tests (tests/test_torch_aec3_*.py): the
bench's 48 kHz stereo configuration on both packages, the echo scene, and
pytree helpers. Everything is made from seeds with numpy."""

import jax
import numpy as np
import torch

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
