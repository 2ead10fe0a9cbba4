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


def tree_where(cond: torch.Tensor, a, b):
    """Per-stream select of every leaf of two states with the same
    structure; a leaf the two share (``a is b``) is kept as it is."""
    if a is b:
        return a
    if dataclasses.is_dataclass(a):
        return type(a)(**{
            f.name: tree_where(cond, getattr(a, f.name), getattr(b, f.name))
            for f in dataclasses.fields(a)
        })
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
