"""The port's checkpoint and resume against the JAX package's on the CPU.

``pack`` / ``unpack`` round-trip a state, raise on a shape mismatch or a
missing leaf, and read and write the JAX package's key paths, so a pool
state packed by either package unpacks in the other (bfloat16 rings from
JAX to the port; the other way JAX would cast the uint16 bits as numbers,
so that direction is float32 only). Through the API
(``tests/torch_jax_api_run.py``'s sessions: 16 kHz mono, AEC3, NS and
AGC2, ``save_stream`` before frame 6 of 12): a JAX file resumes in the
port within relative RMS 1e-3 a frame of JAX continuing, a port file
loads through JAX's ``load_stream`` to the port's state leaf for leaf,
and the port's own resume is bit-equal to its continuing. An injected builder component's state
rides along.
"""

import dataclasses
import io

import jax
import numpy as np
import pytest
import torch

from tests import torch_jax_api_run as run
from tests import torch_threads  # noqa: F401  (one thread a worker)
from webrtc_audio_processing_tpu import apm as j_apm
from webrtc_audio_processing_tpu import config as j_cfg
from webrtc_audio_processing_tpu.utils import checkpoint as j_ckpt

from webrtc_audio_processing_tpu_torch import api, apm, builder
from webrtc_audio_processing_tpu_torch import config as cfg_mod
from webrtc_audio_processing_tpu_torch.utils import checkpoint

B = 2


def _same_leaves(a, b):
    na, nb = apm.state_to_numpy(a), apm.state_to_numpy(b)
    assert na.keys() == nb.keys()
    for k in na:
        assert na[k].dtype == nb[k].dtype, k
        np.testing.assert_array_equal(na[k], nb[k], err_msg=k)


def test_pack_unpack_dict_state():
    state = {"a": torch.arange(6.0).reshape(2, 3),
             "nested": {"b": torch.tensor(3, dtype=torch.int32)},
             "seq": (torch.ones(2, dtype=torch.bool), 7)}
    like = {"a": torch.zeros(2, 3),
            "nested": {"b": torch.zeros((), dtype=torch.int32)},
            "seq": (torch.zeros(2, dtype=torch.bool), 0)}
    out = checkpoint.unpack(checkpoint.pack(state), like)
    torch.testing.assert_close(out["a"], state["a"], rtol=0, atol=0)
    assert int(out["nested"]["b"]) == 3 and out["nested"]["b"].dtype == (
        torch.int32)
    assert out["seq"][0].all() and out["seq"][1] == 7


def test_shape_mismatch_and_missing_leaf_raise():
    blob = checkpoint.pack({"a": torch.zeros(2, 3)})
    with pytest.raises(ValueError):
        checkpoint.unpack(blob, {"a": torch.zeros(3, 2)})
    with pytest.raises(KeyError):
        checkpoint.unpack(blob, {"a": torch.zeros(2, 3),
                                 "b": torch.zeros(2)})


def _geometry(m, ring_dtype="float32"):
    return m.ApmGeometry.create(run.config(
        j_cfg if m is j_apm else cfg_mod), run.RATE, 1,
        aec3_ring_dtype=ring_dtype)


def _jax_pool(ring_dtype="float32"):
    """The JAX package's init_state of the session's geometry for B
    streams, batch first, numpy leaves."""
    one = j_apm.init_state(_geometry(j_apm, ring_dtype))
    return jax.tree_util.tree_map(
        lambda x: np.broadcast_to(np.asarray(x), (B,) + x.shape).copy(), one)


def _stepped_pool(ring_dtype="float32", frames=3):
    """The port's state of B streams after a few frames of the scene, so
    the rings hold data."""
    geo = _geometry(apm, ring_dtype)
    state = apm.init_state(geo, B, "cpu")
    far, near = run.scene(frames)
    for k in range(frames):
        state, _, _, _ = apm.process_stream_pair(
            geo, state, torch.from_numpy(near[k][None].repeat(B, 0)),
            torch.from_numpy(far[k][None].repeat(B, 0)))
    return geo, state


def test_port_pool_round_trip_keeps_every_leaf_and_counter():
    geo, state = _stepped_pool()
    like = apm.init_state(geo, B, "cpu")
    out = checkpoint.unpack(checkpoint.pack(state), like)
    _same_leaves(out, state)
    assert out.frame_counter == state.frame_counter == 3
    assert int(out.aec3_block_ordinal) == apm.block_ordinal(3)


def test_jax_pool_blob_unpacks_in_the_port_and_back():
    """JAX's ``pack`` of a pool state unpacks into the port's state as the
    parity bridge reads it, and the port's ``pack`` unpacks in JAX; the
    keys are JAX's, the port's two counters beside them."""
    tree = _jax_pool()
    geo = _geometry(apm)
    blob = j_ckpt.pack(tree)
    got = checkpoint.unpack(blob, apm.init_state(geo, B, "cpu"))
    _same_leaves(got, apm.state_from_jax(tree, geo))
    with np.load(io.BytesIO(blob)) as z:
        jax_keys = set(z.files)
    with np.load(io.BytesIO(checkpoint.pack(got))) as z:
        port_keys = set(z.files)
    assert port_keys - jax_keys == {".aec3_block_ordinal", ".frame_counter"}
    assert jax_keys <= port_keys
    back = j_ckpt.unpack(checkpoint.pack(got), tree)
    for (p, a), b in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                         jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), b,
                                      err_msg=jax.tree_util.keystr(p))


def test_bf16_rings_round_trip_port_to_port_and_load_from_jax():
    """bf16 rings go as uint16 bit patterns and come back bf16 bit for
    bit; JAX's bf16 leaves (numpy reads them as raw ``V2``) load as the
    same bits."""
    geo, state = _stepped_pool("bfloat16")
    rings = state.aec.buffer
    assert rings.blocks.dtype == torch.bfloat16
    out = checkpoint.unpack(checkpoint.pack(state),
                            apm.init_state(geo, B, "cpu"))
    assert out.aec.buffer.blocks.dtype == torch.bfloat16
    _same_leaves(out, state)
    tree = _jax_pool("bfloat16")
    blob = j_ckpt.pack(tree)
    with np.load(io.BytesIO(blob)) as z:
        assert z[".aec.buffer.blocks"].dtype.kind == "V"
    got = checkpoint.unpack(blob, apm.init_state(geo, B, "cpu"))
    _same_leaves(got, apm.state_from_jax(tree, geo))


def _port_ap():
    """A fresh port API, initialized by the scene's first frame."""
    ap = api.AudioProcessing(run.config(cfg_mod), device="cpu")
    far, near = run.scene()
    run.run_frames(ap, [0], far, near)
    return ap


def test_jax_save_stream_resumes_in_the_port():
    jx = run.jax_session()
    ap = _port_ap()
    checkpoint.load_stream(jx["ckpt"], ap)
    assert ap._state.frame_counter == run.SAVE_AT
    assert int(ap._state.aec3_block_ordinal) == apm.block_ordinal(
        run.SAVE_AT)
    got = run.run_frames(ap, range(run.SAVE_AT, run.N_FRAMES), jx["far"],
                         jx["near"])
    for k, (g, w) in enumerate(zip(got, jx["out"][run.SAVE_AT:])):
        assert run.rel_rms(g, w) <= run.RTOL_RMS, run.SAVE_AT + k


def test_port_resume_is_bit_equal_to_continuing():
    po = run.port_session()
    ap = _port_ap()
    checkpoint.load_stream(po["ckpt"], ap)
    got = run.run_frames(ap, range(run.SAVE_AT, run.N_FRAMES), po["far"],
                         po["near"])
    np.testing.assert_array_equal(got, po["out"][run.SAVE_AT:])


def test_port_save_stream_loads_in_jax():
    """The port's file, complex leaves as JAX's (real, imaginary) pairs
    and no batch axis, loads through JAX's ``load_stream`` into the JAX
    session's API: every leaf of the state it builds equals the port's
    state at the save, and the frame counter is the port's."""
    jx, po = run.jax_session(), run.port_session()
    ap = _port_ap()
    checkpoint.load_stream(po["ckpt"], ap)
    want = apm.state_to_numpy(ap._state)
    j_ckpt.load_stream(po["ckpt"], jx["ap"])
    assert jx["ap"]._frame_index == run.SAVE_AT
    leaves = jax.tree_util.tree_flatten_with_path(jx["ap"]._state)[0]
    assert len(leaves) == sum(
        2 if np.iscomplexobj(v) else 1 for k, v in want.items()
        if k != "aec3_block_ordinal")
    for p, leaf in leaves:
        key = jax.tree_util.keystr(p)[1:]
        part = None
        if key.endswith(("[<flat index 0>]", "[<flat index 1>]")):
            key, part = key[:-len("[<flat index 0>]")], key[-3]
        w = want[key][0]
        if part is not None:
            w = w.real if part == "0" else w.imag
        np.testing.assert_array_equal(np.asarray(leaf), w, err_msg=key)


def test_load_stream_refuses_a_missing_leaf(tmp_path):
    po = run.port_session()
    with np.load(po["ckpt"]) as z:
        cut = next(k for k in z.files if k.startswith("state.ns."))
        arrays = {k: z[k] for k in z.files if k != cut}
    path = str(tmp_path / "cut.npz")
    np.savez(path, **arrays)
    with pytest.raises(KeyError):
        checkpoint.load_stream(path, _port_ap())


def test_injected_builder_state_checkpoints_and_resumes(tmp_path):
    """As tests/test_builder_injection.py's checkpoint test, with a
    capture post-processor whose state (a dict: a frame count and a gain
    per stream) rides in the file under its dict keys."""
    post = builder.CustomProcessing(
        init=lambda rate, ch, b, dev: {
            "n": torch.zeros(b, dtype=torch.int32, device=dev),
            "g": torch.full((b,), 0.5, device=dev)},
        process=lambda st, x: ({"n": st["n"] + 1, "g": st["g"] * 1.01},
                               x * st["g"][:, None, None]))
    cfg = run.config(cfg_mod)

    def make():
        return (builder.AudioProcessingBuilder(cfg)
                .set_capture_post_processing(post).build(device="cpu"))

    far, near = run.scene()
    ap = make()
    run.run_frames(ap, range(6), far, near)
    path = str(tmp_path / "injected.npz")
    checkpoint.save_stream(path, ap)
    cont = run.run_frames(ap, range(6, 10), far, near)
    with np.load(path) as z:
        assert int(z["state.custom_capture_post['n']"]) == 6
    ap2 = make()
    run.run_frames(ap2, [0], far, near)
    checkpoint.load_stream(path, ap2)
    assert int(ap2._state.custom_capture_post["n"][0]) == 6
    resumed = run.run_frames(ap2, range(6, 10), far, near)
    np.testing.assert_array_equal(resumed, cont)
    assert dataclasses.is_dataclass(ap2._state)
