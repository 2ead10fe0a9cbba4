"""Helpers for per-stream selects over batch-first state.

The JAX package writes AEC3 per stream and batches it with ``vmap``; a
per-stream scalar there (shape ``()``) is a ``(B,)`` tensor here. These
helpers broadcast such a scalar over the trailing axes of the values it
selects, and apply one select to every leaf of a state dataclass.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


def where(cond: torch.Tensor, a, b):
    """torch.where with a (B,) or (B, k...) ``cond`` padded on the right to
    the larger rank of ``a`` and ``b``."""
    nd = max(t.dim() for t in (a, b) if torch.is_tensor(t))
    return torch.where(cond.reshape(cond.shape + (1,) * (nd - cond.dim())),
                       a, b)


def children(node):
    """The (key, child) pairs of a state node in the JAX pytree's order: a
    dataclass's fields in order, a dict's items by sorted key, a tuple's or
    list's items by index. None for anything else (a tensor, a plain int,
    None): a leaf. An injected component's state may be any nest of
    these."""
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name))
                for f in dataclasses.fields(node)]
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (tuple, list)):
        return list(enumerate(node))
    return None


def rebuild(node, values: dict):
    """A node of ``node``'s kind with its children replaced by ``values``
    ({key: child}, every key of ``children(node)``)."""
    if dataclasses.is_dataclass(node):
        return type(node)(**values)
    if isinstance(node, dict):
        return {k: values[k] for k in node}
    items = [values[i] for i in range(len(node))]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*items)
    return type(node)(items)


def tree_where(cond: torch.Tensor, a, b):
    """Per-stream select of every leaf of two states with the same
    structure; a leaf the two share (``a is b``) is kept as it is."""
    if a is b:
        return a
    kids = children(a)
    if kids is not None:
        other = dict(children(b))
        return rebuild(a, {k: tree_where(cond, v, other[k])
                           for k, v in kids})
    return where(cond, a, b)


def tile(value: tuple, batch: int, dtype, device) -> torch.Tensor:
    """(B,) + shape copies of a per-stream constant (a tuple), copied to
    the device once."""
    t = const(value, dtype, device)
    return t.expand((batch,) + tuple(t.shape)).clone()


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b], ...] for x (B, N, ...): a per-stream index (B,) gives
    (B, ...), a per-stream index vector (B, k) gives (B, k, ...)."""
    squeeze = idx.dim() == 1
    if squeeze:
        idx = idx[:, None]
    view = idx.to(torch.int64).reshape(idx.shape + (1,) * (x.dim() - 2))
    out = torch.gather(x, 1, view.expand(idx.shape + x.shape[2:]))
    return out[:, 0] if squeeze else out


@functools.lru_cache(maxsize=None)
def _const(key, device):
    value, dtype = key
    return torch.as_tensor(np.asarray(value), dtype=dtype).to(device)


def const(value, dtype, device) -> torch.Tensor:
    """A constant tensor built once per device (no host-to-device copy on
    the step). ``value`` must be hashable: a tuple of numbers."""
    return _const((value, dtype), torch.device(device))
