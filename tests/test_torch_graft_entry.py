"""The port's entry points and shard runner on the CPU.

``graft_entry`` is the port's ``__graft_entry__.py``: ``build``'s pair
step against JAX's ``_build`` (16 kHz mono, B = 4, 2 pairs, relative RMS
1e-3 per stream, BASELINE.md); ``shard_state`` / ``gather_state`` round
trips; and the 48 kHz stereo full-APM step (``dryrun_multigpu``'s) at
B = 16 in 4 shards on repeated CPU devices against the unsharded step,
within tests/test_multichip_sharding.py's bars (outputs atol 1e-6, state
leaves 1e-5), with lanes of identical input kept in lockstep across
shards. The state bar is JAX's 1e-5 of each float leaf's scale
(max(1, max |leaf|)): the CPU's kernels round a few floatS16 leaves (NS's
noise spectrum, ~1e3) one ulp apart at B = 4 and B = 16; integer and
boolean leaves are equal. The card runs the same shards as CUDA graphs on their own streams
(tests/test_torch_cuda.py, chip_smoke.py phase 18).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as j_ge
from tests import torch_threads  # noqa: F401  (one thread a worker)

from webrtc_audio_processing_tpu_torch import apm, graft_entry as ge
from webrtc_audio_processing_tpu_torch import serve_batch, step_graph

B = 16
SHARDS = 4


def _leaves(state):
    return apm.state_to_numpy(state)


@pytest.fixture(scope="module")
def stereo():
    """dryrun_multigpu's geometry, a B = 16 state one pair in, and a pair
    of seeded frames."""
    geo = ge.geometry(ge.RATE, ge.CAP, ge.REN, 48000)
    rng = np.random.default_rng(7)

    def mk(ch):
        return torch.from_numpy(rng.standard_normal(
            (B, 480, ch)).astype(np.float32) * 0.03)

    state = apm.init_state(geo, B, "cpu")
    step_graph.step_pair(geo, state, mk(2), mk(2), mk(2), mk(2))
    return geo, state, tuple(mk(ch) for ch in (2, 2, 2, 2))


def test_shard_and_gather_round_trip(stereo):
    geo, state, _ = stereo
    shards = ge.shard_state(state, ["cpu"] * SHARDS)
    assert [s.frame_parity.shape[0] for s in shards] == [4] * SHARDS
    assert all(s.frame_counter == state.frame_counter for s in shards)
    back = ge.gather_state(shards)
    want, got = _leaves(state), _leaves(back)
    assert want.keys() == got.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # The shards own copies: writing one leaves the state as it was.
    shards[0].frame_parity.add_(1)
    np.testing.assert_array_equal(state.frame_parity.numpy(),
                                  want["frame_parity"])
    assert ge.shard_bounds(7, 3) == [(0, 3), (3, 5), (5, 7)]
    with pytest.raises(ValueError):
        ge.shard_state(state, ["cpu"] * (B + 1))


def test_four_shards_match_the_unsharded_step(stereo):
    geo, state, frames = stereo
    whole = ge.gather_state(ge.shard_state(state, ["cpu"]))  # a copy
    (y0, r0), (y1, r1) = (
        (o[0], o[1]) for o in step_graph.step_pair(geo, whole, *frames))
    runner = ge.ShardedPairStep(geo, state, ["cpu"] * SHARDS)
    (g0, gr0), (g1, gr1) = runner.step(*frames)
    for got, want in ((g0, y0), (g1, y1), (gr0, r0), (gr1, r1)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-6)
    assert_state_close(runner.state(), whole)


def assert_state_close(got, want, bar=1e-5):
    """Every leaf within ``bar`` of its scale, integer leaves equal."""
    want, got = _leaves(want), _leaves(got)
    assert want.keys() == got.keys()
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype, k
        if np.issubdtype(w.dtype, np.inexact):
            scale = max(1.0, float(np.abs(w).max(initial=0.0)))
            assert np.abs(g - w).max(initial=0.0) <= bar * scale, k
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def test_lanes_stay_in_lockstep_across_shards(stereo):
    """Identical input on every lane for 3 pairs: lanes 0 and 1 (one
    shard) equal, lane 15 (another shard) within 1e-4
    (tests/test_multichip_sharding.py:89-108)."""
    geo, state, frames = stereo
    same = [f[:1].expand_as(f).contiguous() for f in frames]
    lanes = apm.init_state(geo, B, "cpu")
    runner = ge.ShardedPairStep(geo, lanes, ["cpu"] * SHARDS)
    for _ in range(3):
        _, (y, _) = runner.step(*same)
    y = y.numpy()
    assert np.isfinite(y).all()
    np.testing.assert_array_equal(y[0], y[1])
    np.testing.assert_allclose(y[0], y[15], rtol=0, atol=1e-4)


def _seeded_pairs(nb, frame):
    rng = np.random.default_rng(3)
    far = 0.1 * rng.standard_normal((4, nb, frame, 1))
    return np.stack([far[0], 0.4 * far[0] + 0.01 * rng.standard_normal(
        (nb, frame, 1)), far[1], 0.4 * far[1] + 0.01 * rng.standard_normal(
        (nb, frame, 1))]).astype(np.float32)


def test_build_is_two_process_stream_pair_calls():
    """``build``'s pair step (16 kHz mono, HPF, AEC3, NS, AGC2) at B = 4
    for 2 pairs is the parity 0 and parity 1 ``apm.process_stream_pair``
    calls bit for bit (the step JAX's parity tests hold to JAX)."""
    init, pair_step, frame = ge.build(16000, 1, 1, 32000, "cpu")
    geo = ge.geometry(16000, 1, 1, 32000)
    state, ref = init(4), init(4)
    frames = _seeded_pairs(4, frame)
    for p in range(2):
        f = [torch.from_numpy(x) for x in (frames if p == 0
                                           else frames[::-1].copy())]
        state, y = pair_step(state, *f)
        ref, _, _, _ = apm.process_stream_pair(geo, ref, f[1], f[0])
        ref, want, _, _ = apm.process_stream_pair(geo, ref, f[3], f[2])
        assert torch.equal(y, want)
    assert state.frame_counter == ref.frame_counter == 4
    assert int(state.aec3_block_ordinal) == int(ref.aec3_block_ordinal) == 10


@pytest.mark.slow
def test_build_matches_jax_build_16k_mono():
    """``build``'s pair step against ``__graft_entry__._build``'s (both
    16 kHz mono, HPF, AEC3, NS, AGC2), B = 4 streams, 2 pairs of seeded
    frames: the second frame's output per stream within relative RMS
    1e-3. Slow: JAX compiles the vmapped two-frame step in one program,
    ~6 min on one CPU with a cold cache."""
    nb, frame = 4, 160
    j_init, j_pair, j_frame = j_ge._build(16000, 1, 1, 32000)
    init, pair_step, p_frame = ge.build(16000, 1, 1, 32000, "cpu")
    assert j_frame == p_frame == frame
    j_state = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (nb,) + x.shape), j_init())
    step = jax.jit(jax.vmap(j_pair, in_axes=(0, 0, 0, 0, 0, None)))
    state = init(nb)
    frames = _seeded_pairs(nb, frame)
    for p in range(2):
        f = frames if p == 0 else frames[::-1].copy()
        j_state, jy = step(j_state, *map(jnp.asarray, f),
                           jnp.asarray(5 * p, jnp.int32))
        state, y = pair_step(state, *map(torch.from_numpy, f))
        jy, y = np.asarray(jy), y.numpy()
        err = np.sqrt(((y - jy) ** 2).sum(axis=(1, 2))
                      / np.maximum((jy ** 2).sum(axis=(1, 2)), 1e-12))
        assert (err <= 1e-3).all(), (p, err)
    assert state.frame_counter == 4
    assert int(state.aec3_block_ordinal) == 10


def test_entry_runs_one_stream():
    fn, args = ge.entry("cpu")
    state, y = fn(*args)
    assert tuple(y.shape) == (1, 160, 1) and bool(torch.isfinite(y).all())
    assert state.frame_counter == 2


def test_dryrun_multigpu_on_cpu_shards(capsys):
    runner, ((_, _), (y, _)) = ge.dryrun_multigpu(SHARDS,
                                                  devices=["cpu"] * SHARDS)
    assert tuple(y.shape) == (2 * SHARDS, 480, 2)
    assert runner.state().frame_counter == 2
    assert bool(torch.isfinite(y).all())
    out = capsys.readouterr().out
    assert "dryrun_multigpu OK: 4 shards" in out and "batch 8" in out
    with pytest.raises(ValueError):
        ge.dryrun_multigpu(SHARDS, devices=["cpu"] * 3)


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
def test_dryrun_multigpu_without_a_card_raises():
    with pytest.raises(RuntimeError, match="CUDA"):
        ge.dryrun_multigpu(2)


def test_serve_batch_on_cpu_shards(capsys):
    assert serve_batch.main(["--streams", "4", "--frames", "4", "--shards",
                             "2", "--cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "sharding 4 streams over 2 shards on 1 devices"
    assert out[1].startswith("4 streams x 4 frames: ")
