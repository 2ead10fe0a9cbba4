"""AEC3's block ordinal as a device tensor, and the pair step the CUDA graph
captures, on the CPU.

The ring writes take the ordinal as a 0-d int32 tensor and write
branch-free; they are held bit for bit to the JAX package's
``ring_write_group`` and ``uniform_dus`` under ``jax.vmap`` with the
position unbatched, at every start of the 48 kHz stereo rings and every
offset of the low-rate ring. The pair step's body (``step_graph.pair_body``:
two frames, every new leaf copied back into the state it came from) is
run eagerly and held bit for bit to plain ``process_stream_pair`` calls on
every leaf, the ordinal included: this is where an aliasing error in the
copy-back shows.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import chip_smoke

from webrtc_audio_processing_tpu.models.aec3 import render_buffer as j_rb

from webrtc_audio_processing_tpu_torch import apm, step_graph
from webrtc_audio_processing_tpu_torch.models.aec3 import render_buffer as rb

from tests.torch_aec3_setup import geometries, ordinal

B = 2


@functools.lru_cache(maxsize=1)
def _buffer_geometries():
    jgeo, geo = geometries()
    return jgeo.aec3.buffer, geo.aec3.buffer


@functools.lru_cache(maxsize=None)
def _j_ring_write_group():
    jgeo, _ = _buffer_geometries()
    return jax.jit(jax.vmap(
        lambda buf, group, start: j_rb.ring_write_group(jgeo, buf, group,
                                                        start),
        in_axes=(0, 0, None)))


def test_geometry_is_the_48k_stereo_rings():
    """L = 167 blocks, a 25-row mirror and a 2448-sample low-rate ring of
    16-sample sub-blocks: the positions repeat every lcm(167, 153) pairs,
    too many for one graph per ring phase."""
    _, geo = _buffer_geometries()
    assert (geo.num_blocks, geo.pad, geo.ds_size, geo.sub_block_size) == (
        167, 25, 2448, 16)
    assert np.lcm(geo.num_blocks, geo.ds_size // geo.sub_block_size) == 25551


@pytest.mark.parametrize("ring", ["sf", "blocks"])
def test_ring_write_group_matches_jax_at_every_start(ring):
    """A group of 5 rows (a frame pair's staged rows) written at every
    start in [0, L): the first write, then the mirror copy (start < pad),
    the wrapped tail (start + 5 > L) or the scratch rows, bit for bit."""
    _, geo = _buffer_geometries()
    width = geo.sf_row_fp if ring == "sf" else geo.blocks_row_fp
    rng = np.random.default_rng(11 if ring == "sf" else 12)
    write = _j_ring_write_group()
    for start in range(geo.num_blocks):
        buf = rng.standard_normal((B, geo.rows, width)).astype(np.float32)
        group = rng.standard_normal(
            (B, rb.PAIR_BLOCKS, width)).astype(np.float32)
        want = np.asarray(write(buf, group, np.int32(start)))
        got = torch.from_numpy(buf.copy())
        rb._ring_write_group(geo, got, torch.from_numpy(group),
                             ordinal(start))
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"start {start}")


def test_ring_write_group_takes_the_flush_positions():
    """The flush's starts are tensors on the ring's device; a group wider
    than the mirror is refused."""
    _, geo = _buffer_geometries()
    buf = torch.zeros((1, geo.rows, 8))
    with pytest.raises(ValueError):
        rb._ring_write_group(geo, buf, torch.zeros((1, geo.pad + 1, 8)),
                             ordinal(0))
    start = rb.s_write_index(geo, ordinal(3))
    assert start.dim() == 0 and start.dtype == torch.int32
    assert int(start) == geo.num_blocks - 3


def test_lowrate_write_matches_jax_at_every_offset():
    """The decimated sub-block written at lr_write(n) for n = 0 .. 152,
    which reaches every offset of the ring in steps of 16, bit for bit
    against ``uniform_dus``."""
    jgeo, geo = _buffer_geometries()
    write = jax.jit(jax.vmap(
        lambda buf, sub, n: j_rb.uniform_dus(buf, sub,
                                             j_rb.lr_write_index(jgeo, n)),
        in_axes=(0, 0, None)))
    rng = np.random.default_rng(13)
    offsets = set()
    for n in range(geo.ds_size // geo.sub_block_size):
        buf = rng.standard_normal((B, geo.ds_size)).astype(np.float32)
        sub = rng.standard_normal((B, geo.sub_block_size)).astype(np.float32)
        want = np.asarray(write(buf, sub, np.int32(n)))
        got = torch.from_numpy(buf.copy())
        rb.write_lowrate(geo, got, torch.from_numpy(sub), ordinal(n))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"n {n}")
        offsets.add(int(rb.lr_write_index(geo, ordinal(n))))
    assert offsets == set(range(0, geo.ds_size, geo.sub_block_size))


def _scene_frames(mode, n_frames):
    rate, channels, _ = chip_smoke.BENCH_MODES[mode]
    frame = rate // 100
    render, capture = chip_smoke.echo_scene(n_frames, chip_smoke.SEED,
                                            range(B), rate, channels)
    return [(torch.from_numpy(render[:, f * frame:(f + 1) * frame].copy()),
             torch.from_numpy(capture[:, f * frame:(f + 1) * frame].copy()))
            for f in range(n_frames)]


@pytest.mark.parametrize("mode", ["48k_stereo", "16k_mono"])
def test_pair_body_equals_plain_steps_on_every_leaf(mode):
    """Three pairs of ``step_graph.step_pair`` (the graph's body run
    eagerly, the state updated in place) against six plain
    ``process_stream_pair`` calls from an equal state: every output, stat
    and state leaf bit for bit, the block ordinal included (15)."""
    geo = chip_smoke.aec3_geometry(mode, pair_kernel=False)
    frames = _scene_frames(mode, 6)
    owned = apm.init_state(geo, B, device="cpu")
    plain = apm.init_state(geo, B, device="cpu")
    for p in range(3):
        (r0, c0), (r1, c1) = frames[2 * p], frames[2 * p + 1]
        outs = step_graph.step_pair(geo, owned, r0, c0, r1, c1)
        for (out, rout, stats), (r, c) in zip(outs, ((r0, c0), (r1, c1))):
            plain, p_out, p_rout, p_stats = apm.process_stream_pair(
                geo, plain, c, r)
            assert torch.equal(out, p_out) and torch.equal(rout, p_rout)
            assert set(stats) == set(p_stats)
            for k, v in p_stats.items():
                assert torch.equal(stats[k], v), k
    assert owned.frame_counter == plain.frame_counter == 6
    got, want = apm.state_to_numpy(owned), apm.state_to_numpy(plain)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert int(owned.aec3_block_ordinal) == 15


def test_copy_into_clones_a_leaf_that_moved_to_another_field():
    """A new state whose fields swap two old leaves: both owned leaves get
    the other's old value (copying in field order without the clone would
    give both the same). An owned state whose leaves share storage is
    refused until untied."""
    state = apm.init_state(chip_smoke.aec3_geometry("16k_mono", False), B,
                           device="cpu")
    with pytest.raises(ValueError, match="share storage"):
        step_graph.copy_into(state, state)  # init_state ties two counters
    step_graph.untie(state)
    a = state.input_rms.sum_square
    b = state.output_rms.sum_square
    a.copy_(torch.tensor([1.0, 2.0]))
    b.copy_(torch.tensor([3.0, 4.0]))
    swapped = apm.ApmState(**{
        **vars(state),
        "input_rms": type(state.input_rms)(
            **{**vars(state.input_rms), "sum_square": b}),
        "output_rms": type(state.output_rms)(
            **{**vars(state.output_rms), "sum_square": a}),
    })
    step_graph.copy_into(state, swapped)
    assert state.input_rms.sum_square is a
    assert a.tolist() == [3.0, 4.0] and b.tolist() == [1.0, 2.0]


def test_pair_step_refuses_an_odd_frame_and_a_cpu_graph():
    geo = chip_smoke.aec3_geometry("16k_mono", pair_kernel=False)
    state = apm.init_state(geo, B, device="cpu")
    (r0, c0), (r1, c1) = _scene_frames("16k_mono", 2)
    state.frame_counter = 1
    with pytest.raises(ValueError, match="even frame"):
        step_graph.step_pair(geo, state, r0, c0, r1, c1)
    state.frame_counter = 0
    with pytest.raises(ValueError, match="on the card"):
        step_graph.PairGraph(geo, state)


def test_ordinal_is_a_device_scalar_that_advances_by_two_and_three():
    """The ordinal starts at 0, advances by 2 on an even frame and 3 on an
    odd one, stays a 0-d int32 tensor on the state's device, and
    ``state_from_jax`` sets it from the frame counter."""
    geo = chip_smoke.aec3_geometry("16k_mono", pair_kernel=False)
    state = apm.init_state(geo, B, device="cpu")
    seen = [int(state.aec3_block_ordinal)]
    for r, c in _scene_frames("16k_mono", 3):
        state, _, _, _ = apm.process_stream_pair(geo, state, c, r)
        n = state.aec3_block_ordinal
        assert n.dim() == 0 and n.dtype == torch.int32
        assert n.device.type == "cpu"
        seen.append(int(n))
    assert seen == [0, 2, 5, 7]
    assert [apm.block_ordinal(f) for f in range(4)] == seen
    template = apm.init_state(geo, 1, device="cpu")
    rebuilt = apm.tree_to_state(template, template)
    assert int(rebuilt.aec3_block_ordinal) == 0


def test_select_streams_copies_the_ordinal():
    """chip_smoke's per-stream snapshot indexes every leaf but the
    ordinal, which it copies."""
    geo = chip_smoke.aec3_geometry("16k_mono", pair_kernel=False)
    state = apm.init_state(geo, 3, device="cpu")
    state.aec3_block_ordinal.fill_(42)
    sel = chip_smoke.select_streams(state, torch.tensor([0, 2]), "cpu")
    assert sel.aec3_block_ordinal.dim() == 0
    assert int(sel.aec3_block_ordinal) == 42
    assert sel.aec3_block_ordinal.data_ptr() != (
        state.aec3_block_ordinal.data_ptr())
    assert sel.aec.buffer.lowrate.shape[0] == 2
