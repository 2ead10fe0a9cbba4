"""Checkpoint and resume of stream states.

Port of ``webrtc_audio_processing_tpu/utils/checkpoint.py``. The reference
has no checkpointing (its nearest analogs are ``Initialize()`` and the AEC
dump); here every per-stream carry is a dataclass of fixed-size tensors,
so a live call, or a pool of thousands of them, is a flat array dump:

* ``pack(state)`` / ``unpack(blob, like)``: in-memory bytes, for moving
  streams between cards or hosts;
* ``save(path, state)`` / ``load(path, like)``: the same through a file;
* ``save_stream(path, ap)`` / ``load_stream(path, ap)``: a live
  ``api.AudioProcessing`` with the host counters it resumes from.

The format is the JAX package's: a numpy ``.npz`` keyed by each leaf's
JAX pytree key path (``jax.tree_util.keystr``: ``.a.b`` for fields,
``['k']`` for dict keys, ``[0]`` for sequence items), the structure taken
from ``like``. The state is walked with ``ops.batch.children`` in the JAX
pytree's order. A bfloat16 leaf (AEC3's rings with
``aec3_ring_dtype="bfloat16"``) is written as its uint16 bit patterns, as
``apm.state_to_numpy`` gives it; the JAX package's bfloat16 leaves load
here as numpy's raw 2-byte ``V2`` arrays, read as the same bits.

Two fields of the port's state are not leaves of the JAX state: AEC3's
block ordinal (a 0-d tensor) and the frame counter (a plain int). ``pack``
writes them under their paths and ``unpack`` restores them from the blob
when it holds them, else keeps ``like``'s (a JAX blob holds neither).
``save_stream`` leaves both out, as the JAX package does, and writes the
frame counter as ``host/frame_index``; ``load_stream`` rebuilds the
ordinal from it with ``apm.block_ordinal``.
"""

from __future__ import annotations

import dataclasses
import io

import numpy as np
import torch

from webrtc_audio_processing_tpu_torch.ops import batch as batch_ops

__all__ = ["save", "load", "pack", "unpack", "save_stream", "load_stream"]

_NONE = "__none__"
# The JAX API's state crosses its jit boundary with each complex leaf as a
# (real, imag) pair (utils/complex_boundary.py there); its key paths.
_RE, _IM = "[<flat index 0>]", "[<flat index 1>]"


def _walk(node, path=""):
    """(key path, leaf) of every tensor and plain-int leaf of a state, in
    the JAX pytree's order; None skipped."""
    if node is None:
        return
    if isinstance(node, (bool, int)) or torch.is_tensor(node):
        yield path, node
        return
    kids = batch_ops.children(node)
    if kids is None:
        raise TypeError(f"{path or 'the state'}: {type(node).__name__} is "
                        "not a state node")
    dc = dataclasses.is_dataclass(node)
    for k, v in kids:
        yield from _walk(v, f"{path}.{k}" if dc else f"{path}[{k!r}]")


def _rebuild(node, leaf_fn, path=""):
    """``node`` with each leaf replaced by ``leaf_fn(path, leaf)``."""
    if node is None:
        return None
    if isinstance(node, (bool, int)) or torch.is_tensor(node):
        return leaf_fn(path, node)
    dc = dataclasses.is_dataclass(node)
    return batch_ops.rebuild(node, {
        k: _rebuild(v, leaf_fn, f"{path}.{k}" if dc else f"{path}[{k!r}]")
        for k, v in batch_ops.children(node)})


def _port_only(leaf) -> bool:
    """A plain int (the frame counter) or a 0-d tensor (AEC3's block
    ordinal): the port's, not the JAX state's."""
    return not torch.is_tensor(leaf) or leaf.dim() == 0


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _to_tensor(key: str, arr: np.ndarray, ref: torch.Tensor) -> torch.Tensor:
    """``arr`` as a tensor of ``ref``'s dtype on ``ref``'s device."""
    if tuple(arr.shape) != tuple(ref.shape):
        raise ValueError(f"checkpoint leaf {key!r} shape {arr.shape} != "
                         f"state shape {tuple(ref.shape)}")
    bits = arr.dtype.kind == "V" or arr.dtype == np.uint16
    if ref.dtype == torch.bfloat16 and bits:
        if arr.dtype.itemsize != 2:
            raise ValueError(f"checkpoint leaf {key!r}: {arr.dtype} for a "
                             "bfloat16 leaf")
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
        return t.to(ref.device)
    if arr.dtype.kind == "V":
        raise ValueError(f"checkpoint leaf {key!r}: raw {arr.dtype} bits "
                         f"for a {ref.dtype} leaf")
    return torch.from_numpy(np.array(arr, copy=True)).to(ref.device,
                                                         ref.dtype)


def _arrays(state) -> dict:
    out = {}
    for key, leaf in _walk(state):
        out[key or _NONE] = (np.asarray(leaf, np.int64)
                             if not torch.is_tensor(leaf) else _to_numpy(leaf))
    return out


def pack(state) -> bytes:
    """Serialize a state (a dataclass, dict, tuple or list of tensors, or
    one tensor) to bytes (npz)."""
    buf = io.BytesIO()
    np.savez(buf, **_arrays(state))
    return buf.getvalue()


def _from_arrays(arrays: dict, like):
    def leaf(path, ref):
        key = path or _NONE
        if _port_only(ref):
            if key not in arrays:
                return ref
            if torch.is_tensor(ref):
                return _to_tensor(key, arrays[key], ref)
            return type(ref)(arrays[key])
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        return _to_tensor(key, arrays[key], ref)

    return _rebuild(like, leaf)


def unpack(blob: bytes, like):
    """Rebuild a state from ``pack``'s bytes (or the JAX package's), with
    ``like`` (a state of the same structure, for example a fresh
    ``init_state``) giving the structure and each leaf's dtype and device.
    A leaf the blob lacks raises KeyError, one of another shape
    ValueError."""
    with np.load(io.BytesIO(blob)) as data:
        arrays = {k: data[k] for k in data.files}
    return _from_arrays(arrays, like)


def save(path: str, state) -> None:
    with open(path, "wb") as f:
        f.write(pack(state))


def load(path: str, like):
    with open(path, "rb") as f:
        return unpack(f.read(), like)


# ---------------------------------------------------------------- API layer


def save_stream(path: str, ap) -> None:
    """Checkpoint a live ``api.AudioProcessing``: its state, one stream
    (the batch axis dropped, as the JAX API holds it; a complex leaf as
    its real and imaginary parts, as the JAX API's state crosses its jit
    boundary), and the host counters it resumes from."""
    st = ap._state
    if st is None:
        raise ValueError("AudioProcessing not initialized; nothing to save")
    merged = {}
    for key, leaf in _walk(st):
        if _port_only(leaf):
            continue
        arr = _to_numpy(leaf[0])
        if np.iscomplexobj(arr):
            merged[f"state{key}{_RE}"] = arr.real.copy()
            merged[f"state{key}{_IM}"] = arr.imag.copy()
        else:
            merged[f"state{key}"] = arr
    merged["host/frame_index"] = np.asarray(st.frame_counter)
    merged["host/stream_delay_ms"] = np.asarray(ap._stream_delay_ms)
    merged["host/render_queue"] = np.asarray(len(ap._render_queue))
    with open(path, "wb") as f:
        np.savez(f, **merged)


def load_stream(path: str, ap) -> None:
    """Restore a ``save_stream`` checkpoint (the port's or the JAX
    package's) into an initialized ``api.AudioProcessing`` of the same
    config and format; a leaf missing raises KeyError, one of another
    shape ValueError."""
    from webrtc_audio_processing_tpu_torch import apm

    if ap._state is None:
        raise ValueError(
            "initialize the AudioProcessing (process one frame) before "
            "restoring")
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}

    def leaf(path, ref):
        if _port_only(ref):
            return ref
        key = "state" + path
        if ref.is_complex():
            if key + _RE not in arrays:
                raise KeyError(f"checkpoint missing leaf {key + _RE!r}")
            re, im = arrays[key + _RE], arrays[key + _IM]
            arr = (re + 1j * im).astype(np.complex64)
        else:
            if key not in arrays:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = arrays[key]
        return _to_tensor(key, arr[None], ref)

    state = _rebuild(ap._state, leaf)
    frame_index = int(arrays["host/frame_index"])
    ordinal = state.aec3_block_ordinal
    if ordinal is not None:
        ordinal = torch.full_like(ordinal, apm.block_ordinal(frame_index))
    ap._state = dataclasses.replace(state, frame_counter=frame_index,
                                    aec3_block_ordinal=ordinal)
    ap._stream_delay_ms = int(arrays["host/stream_delay_ms"])
