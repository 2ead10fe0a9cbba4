"""Shared helpers of the AGC1 and VAD parity tests (JAX package against
the port, on the CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests import torch_threads  # noqa: F401  (one thread a worker)
from webrtc_audio_processing_tpu_torch.apm import state_to_numpy


def t(a, dtype=None):
    out = torch.from_numpy(np.array(a, copy=True))
    return out if dtype is None else out.to(dtype)


def batched(tree, b):
    """A JAX per-stream state broadcast to a leading batch axis."""
    return jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (b,) + a.shape), tree)


def flat(tree) -> dict:
    """{dotted path: numpy} of a JAX pytree."""
    return {jax.tree_util.keystr(p)[1:]: np.asarray(leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_states(port_state, jax_state, rtol=None, skip=()):
    """Integer and bool leaves equal; float leaves equal, or within
    ``rtol`` of the leaf's scale when given."""
    p = state_to_numpy(port_state)
    j = flat(jax_state)
    assert set(p) == set(j), set(p) ^ set(j)
    for k, a in p.items():
        if any(s in k for s in skip):
            continue
        b = j[k]
        assert a.shape == b.shape, (k, a.shape, b.shape)
        if a.dtype.kind in "iub" or rtol is None or not a.size:
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            scale = max(np.abs(b).max(), 1e-6)
            err = np.abs(a.astype(np.float64) - b).max() / scale
            assert err <= rtol, (k, err)


def compile_all(jobs: dict) -> dict:
    """{name: (fn, example args)} -> {name: compiled fn}: each ``fn`` jitted,
    lowered at its example arguments and compiled, all in a thread pool
    (XLA compiles in parallel); the compiled functions take arguments of
    the same shapes."""
    import concurrent.futures

    def one(item):
        fn, args = item
        return jax.jit(fn).lower(*args).compile()

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        done = list(pool.map(one, jobs.values()))
    return dict(zip(jobs, done))
