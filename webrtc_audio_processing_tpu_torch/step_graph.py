"""The bench's frame-pair step as one captured CUDA graph.

The counterpart of ``bench.py``'s jitted chunk (bench.py:154-163) and of
``api.py``'s ``jax.jit`` of the step: the body is ``bench.py``'s
``pair_step`` (:94-105), two ``Apm.forward`` calls, an even frame then an
odd one, so AEC3 inserts its 5 blocks per pair on a static cadence. It is
captured once and replayed for every later pair, one graph launch in
place of the step's ~16,600 kernel launches.

A graph replays the addresses it captured, so the state lives in tensors
the graph owns: each new leaf the two steps make is copied back into the
leaf it replaces (the AEC3 rings, written in place, are their own leaf),
and AEC3's block ordinal is a device tensor the body advances by 5. The
frame counter stays a Python int; it fixes only the parity, and capture
starts on an even frame.

Usage, with ``state`` from ``apm.init_state`` on the card::

    graph = PairGraph(geo, state)   # warm-up on a copy of the state
    graph.capture()
    for ...:
        (out0, rout0, stats0), (out1, rout1, stats1) = graph.replay(
            r0, c0, r1, c1)         # (B, frame, ch) each; clone to keep

``step_pair`` is the same body run eagerly, on any device: one call is
what one replay does.
"""

from __future__ import annotations

import copy
import dataclasses
import time

import torch

from webrtc_audio_processing_tpu_torch import apm


def _tensor_leaves(node):
    """The tensors of a state in field order (None, ints and empty tensors,
    which hold no storage, skipped)."""
    if node is None or isinstance(node, int):
        return
    if dataclasses.is_dataclass(node):
        for f in dataclasses.fields(node):
            yield from _tensor_leaves(getattr(node, f.name))
    elif node.numel():
        yield node


def _same_view(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.data_ptr() == b.data_ptr() and a.shape == b.shape
            and a.stride() == b.stride())


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def untie(state) -> None:
    """Give every tensor leaf of ``state`` a storage of its own, in place:
    a leaf that shares one with an earlier leaf (``render_buffer.reset``
    gives two counters one zero tensor) becomes a clone, so that copying
    new values into the leaves never writes one leaf through another."""
    seen = set()

    def walk(node):
        for f in dataclasses.fields(node):
            value = getattr(node, f.name)
            if dataclasses.is_dataclass(value):
                walk(value)
            elif isinstance(value, torch.Tensor) and value.numel():
                if _storage(value) in seen:
                    value = value.clone()
                    setattr(node, f.name, value)
                seen.add(_storage(value))

    walk(state)


def copy_into(owned, new) -> None:
    """Copy every tensor leaf of the state ``new`` into the matching leaf
    of ``owned`` (untied: no two of its leaves share storage), in place. A
    leaf that already is the owned one (the AEC3 rings) is skipped. A new
    leaf that lies in the storage of some owned leaf (an old leaf moved to
    another field) is cloned before any copy, so no copy reads a leaf an
    earlier copy wrote."""
    pairs = list(zip(_tensor_leaves(owned), _tensor_leaves(new),
                     strict=True))
    owned_storage = {_storage(o) for o, _ in pairs}
    if len(owned_storage) != len(pairs):
        raise ValueError("two leaves of the owned state share storage; "
                         "untie() it first")
    moves = []
    for dst, src in pairs:
        if _same_view(dst, src):
            continue
        if _storage(src) in owned_storage:
            src = src.clone()
        moves.append((dst, src))
    for dst, src in moves:
        dst.copy_(src)


def _check_even(state: apm.ApmState) -> None:
    if state.frame_counter % 2:
        raise ValueError(
            f"a frame pair starts on an even frame; the state is at frame "
            f"{state.frame_counter}")


def pair_body(module: apm.Apm, state: apm.ApmState, r0, c0, r1, c1):
    """Frames 0 and 1 of a pair from ``state`` (at an even frame), every
    new leaf copied back into ``state``; its frame counter is the caller's
    to advance. Returns ((out, render_out, stats) of each frame)."""
    s, y0, ro0, st0 = module(state, c0, r0)
    s, y1, ro1, st1 = module(s, c1, r1)
    copy_into(state, s)
    return (y0, ro0, st0), (y1, ro1, st1)


def step_pair(geo: apm.ApmGeometry, state: apm.ApmState, r0, c0, r1, c1):
    """One replay's work run eagerly: the pair body on ``state`` (untied
    first) in place, then the frame counter advanced by 2."""
    _check_even(state)
    untie(state)
    outs = pair_body(apm.module_for(geo, c0.device), state, r0, c0, r1, c1)
    state.frame_counter += 2
    return outs


class PairGraph:
    """The pair step of ``geo`` captured as one CUDA graph over ``state``,
    which the graph owns from here on: replays advance it in place."""

    def __init__(self, geo: apm.ApmGeometry, state: apm.ApmState):
        dev = state.frame_parity.device
        if dev.type != "cuda":
            raise ValueError(f"a CUDA graph needs the state on the card, not "
                             f"on {dev}")
        if geo.aec3 is None:
            raise ValueError("the pair step is the AEC3 cadence; this "
                             "geometry runs no echo canceller")
        _check_even(state)
        untie(state)
        self.state, self.device = state, dev
        # The device of a state tensor (cuda:0, never bare "cuda") keys the
        # module and every constant table, in the warm-up and the capture.
        self.module = apm.module_for(geo, dev)
        B = state.frame_parity.shape[0]
        f32 = dict(dtype=torch.float32, device=dev)
        ren = (B, geo.render_input_rate // 100, geo.num_render_channels)
        cap = (B, geo.capture_input_rate // 100, geo.num_capture_channels)
        self.r0, self.r1 = torch.zeros(ren, **f32), torch.zeros(ren, **f32)
        self.c0, self.c1 = torch.zeros(cap, **f32), torch.zeros(cap, **f32)
        self.stream = torch.cuda.Stream(dev)
        self.graph = None
        self.outputs = None
        self.capture_seconds = None
        # One pair of warm-up on a copy, on the capture's stream: builds the
        # kernels, cuFFT's plans, the cached constant tables and the
        # stream's cuBLAS workspace, none of which may happen inside the
        # capture.
        scratch = copy.deepcopy(state)
        self.stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(self.stream):
            pair_body(self.module, scratch, self.r0, self.c0, self.r1,
                      self.c1)
        torch.cuda.current_stream(dev).wait_stream(self.stream)
        torch.cuda.synchronize(dev)
        del scratch
        torch.cuda.empty_cache()

    def capture(self) -> None:
        """Record the pair body; nothing runs and the state stays as it
        is. A failure raises: there is no eager path behind the graph."""
        if self.graph is not None:
            raise RuntimeError("the pair step is captured already")
        _check_even(self.state)
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, stream=self.stream):
            outputs = pair_body(self.module, self.state, self.r0, self.c0,
                                self.r1, self.c1)
        torch.cuda.synchronize(self.device)
        self.capture_seconds = time.perf_counter() - t0
        self.graph, self.outputs = graph, outputs

    def set_ordinal(self, n0: int) -> None:
        """Set AEC3's block ordinal on the device (``bench.py``'s
        ``n0s_for``), without a host-to-device copy."""
        self.state.aec3_block_ordinal.fill_(n0)

    def replay(self, r0, c0, r1, c1):
        """Copy a pair's frames into the graph's inputs and replay it. The
        outputs are the graph's own tensors, overwritten by the next
        replay: clone what you keep."""
        if self.graph is None:
            raise RuntimeError("capture() the pair step before replaying it")
        for dst, src in ((self.r0, r0), (self.c0, c0), (self.r1, r1),
                         (self.c1, c1)):
            dst.copy_(src)
        self.graph.replay()
        self.state.frame_counter += 2
        return self.outputs
