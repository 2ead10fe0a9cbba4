"""The bench's frame-pair step as one captured CUDA graph.

The counterpart of ``bench.py``'s jitted chunk (bench.py:154-163) and of
``api.py``'s ``jax.jit`` of the step: the body is ``bench.py``'s
``pair_step`` (:94-105), two ``Apm.forward`` calls, an even frame then an
odd one, so AEC3 inserts its 5 blocks per pair on a static cadence. It is
captured once per pair of the cadence's period (``apm.parity_period``: one
pair, or three with the hybrid AGC's 30 ms analytics VAD, all over one
state and one memory pool) and replayed for every later pair, one graph
launch in place of the step's ~16,600 kernel launches.

The hybrid AGC1's applied mic volume is an input tensor of the graphs,
``volume``, (B,) int32, read as it stands at each replay: the caller
closes the analog loop between replays on the device, for example with
``graph.volume.copy_(stats1["agc1_recommended_level"])``. So is the mobile
AECM's reported stream delay, ``delay``, (B,) int32 in ms, 0 until the
caller fills it.

A graph replays the addresses it captured, so the state lives in tensors
the graph owns: each new leaf the two steps make is copied back into the
leaf it replaces (the AEC3 rings, written in place, are their own leaf),
and AEC3's block ordinal is a device tensor the body advances by 5. The
frame counter stays a Python int; it fixes only the frame's phase in the
period (``f % 2`` for AEC3, ``f % 3`` for the analytics VAD). Capture
starts on an even frame, and each graph is kept under the phase it was
captured at, so a state at any even frame replays the right one.

Usage, with ``state`` from ``apm.init_state`` on the card::

    graph = PairGraph(geo, state)   # warm-up on a copy of the state
    graph.capture()
    for ...:
        (out0, rout0, stats0), (out1, rout1, stats1) = graph.replay(
            r0, c0, r1, c1)         # (B, frame, ch) each; clone to keep

``step_pair`` is the same body run eagerly, on any device: one call is
what one replay does.

``FrameGraphs`` is the one-frame step as one graph per frame of the
period, over one owned state and one memory pool, replayed in turn: the
counterpart of ``api.py``'s ``jax.jit`` of each parity and the step that
``runtime.BatchEngine`` drives one frame a call.
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


def _card_of(state: apm.ApmState) -> torch.device:
    dev = state.frame_parity.device
    if dev.type != "cuda":
        raise ValueError(f"a CUDA graph needs the state on the card, not "
                         f"on {dev}")
    return dev


def _warm_up(stream, state: apm.ApmState, body) -> None:
    """Run ``body`` on a copy of ``state`` on the capture's ``stream``: it
    builds the kernels, cuFFT's plans, the cached constant tables and the
    stream's cuBLAS workspace, none of which may happen inside a capture."""
    dev = stream.device
    scratch = copy.deepcopy(state)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        body(scratch)
    torch.cuda.current_stream(dev).wait_stream(stream)
    torch.cuda.synchronize(dev)
    del scratch
    torch.cuda.empty_cache()


def pair_body(module: apm.Apm, state: apm.ApmState, r0, c0, r1, c1,
              volume=None, delay=None):
    """Frames 0 and 1 of a pair from ``state`` (at an even frame), every
    new leaf copied back into ``state``; its frame counter is the caller's
    to advance. ``volume``: the applied mic volume of both frames, (B,)
    int32, or None; ``delay``: the stream delay of both frames in ms, (B,)
    int32, or None. Returns ((out, render_out, stats) of each frame)."""
    kw = dict(applied_input_volume=volume, stream_delay_ms=delay)
    s, y0, ro0, st0 = module(state, c0, r0, **kw)
    s, y1, ro1, st1 = module(s, c1, r1, **kw)
    copy_into(state, s)
    return (y0, ro0, st0), (y1, ro1, st1)


def step_pair(geo: apm.ApmGeometry, state: apm.ApmState, r0, c0, r1, c1,
              volume=None, delay=None):
    """One replay's work run eagerly: the pair body on ``state`` (untied
    first) in place, then the frame counter advanced by 2."""
    _check_even(state)
    untie(state)
    outs = pair_body(apm.module_for(geo, c0.device), state, r0, c0, r1, c1,
                     volume, delay)
    state.frame_counter += 2
    return outs


def _volume_input(geo: apm.ApmGeometry, B: int, dev):
    """The applied-volume input of a graph: a (B,) int32 tensor where the
    step reads one (the hybrid AGC1), else None."""
    if geo.agc1_hybrid:
        return torch.zeros(B, dtype=torch.int32, device=dev)
    return None


def _delay_input(geo: apm.ApmGeometry, B: int, dev):
    """The stream-delay input of a graph: a (B,) int32 tensor where the
    step reads one (the mobile AECM), else None."""
    if geo.aecm is not None:
        return torch.zeros(B, dtype=torch.int32, device=dev)
    return None


def _capture_in_turn(stream, state: apm.ApmState, frames: int, n: int,
                     period: int, body):
    """Capture ``body`` ``n`` times in one memory pool, the i-th with the
    frame counter moved on by ``frames * i`` for the capture only, so the
    graphs replay in the order of their capture. Returns ({the phase in
    the period each was captured at: (graph, outputs)}, seconds taken);
    nothing runs and the state stays as it is. A failure raises: there is
    no eager path behind the graphs."""
    done, pool = {}, None
    t0 = time.perf_counter()
    for i in range(n):
        graph = torch.cuda.CUDAGraph()
        state.frame_counter += frames * i
        try:
            with torch.cuda.graph(graph, pool=pool, stream=stream):
                outputs = body()
            phase = state.frame_counter % period
        finally:
            state.frame_counter -= frames * i
        pool = graph.pool()
        done[phase] = (graph, outputs)
    torch.cuda.synchronize(stream.device)
    return done, time.perf_counter() - t0


class PairGraph:
    """The pair step of ``geo`` captured as CUDA graphs over ``state``, one
    per pair of the period, which the graphs own from here on: replays
    advance it in place."""

    def __init__(self, geo: apm.ApmGeometry, state: apm.ApmState):
        dev = _card_of(state)
        if geo.aec3 is None and geo.aecm is None:
            raise ValueError("the pair step is the echo canceller's "
                             "cadence; this geometry runs none")
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
        self.volume = _volume_input(geo, B, dev)
        self.delay = _delay_input(geo, B, dev)
        self.period = apm.parity_period(geo)
        self.stream = torch.cuda.Stream(dev)
        self.graphs = None
        self.capture_seconds = None
        _warm_up(self.stream, state, self._warm_body)

    def _body(self, state):
        return pair_body(self.module, state, self.r0, self.c0, self.r1,
                         self.c1, self.volume, self.delay)

    def _warm_body(self, scratch):
        for _ in range(self.period // 2):
            self._body(scratch)
            scratch.frame_counter += 2

    def capture(self) -> None:
        """Record the pair body at each pair of the period, from the
        state's own; nothing runs and the state stays as it is."""
        if self.graphs is not None:
            raise RuntimeError("the pair step is captured already")
        _check_even(self.state)
        self.graphs, self.capture_seconds = _capture_in_turn(
            self.stream, self.state, 2, self.period // 2, self.period,
            lambda: self._body(self.state))

    def set_ordinal(self, n0: int) -> None:
        """Set AEC3's block ordinal on the device (``bench.py``'s
        ``n0s_for``), without a host-to-device copy."""
        self.state.aec3_block_ordinal.fill_(n0)

    def replay(self, r0, c0, r1, c1):
        """Copy a pair's frames into the graphs' inputs and replay the
        graph of the state's pair in the period (``volume`` is read as it
        stands). The outputs are the graph's own tensors, overwritten by
        its next replay: clone what you keep."""
        if self.graphs is None:
            raise RuntimeError("capture() the pair step before replaying it")
        for dst, src in ((self.r0, r0), (self.c0, c0), (self.r1, r1),
                         (self.c1, c1)):
            dst.copy_(src)
        graph, outputs = self.graphs[self.state.frame_counter % self.period]
        graph.replay()
        self.state.frame_counter += 2
        return outputs


def frame_body(module: apm.Apm, state: apm.ApmState, render, capture,
               volume=None, delay=None):
    """One frame from ``state``, every new leaf copied back into it; its
    frame counter is the caller's to advance. Returns (out, render_out,
    stats)."""
    s, out, render_out, stats = module(state, capture, render,
                                       applied_input_volume=volume,
                                       stream_delay_ms=delay)
    copy_into(state, s)
    return out, render_out, stats


class FrameGraphs:
    """The one-frame step of ``geo`` captured as one CUDA graph per frame
    of the period (``apm.parity_period``: 2, or 6 with the hybrid AGC)
    over ``state``, which they own from here on.

    The graphs read and write the same owned leaves and share one memory
    pool; they replay in turn, in the order of their capture, which starts
    at the state's frame. AEC3's block ordinal advances by 2 or 3 on the
    device inside each graph. Each graph's outputs are its own tensors,
    overwritten by its next replay. The hybrid AGC1's applied volume is
    the input ``volume``, (B,) int32, and the mobile AECM's stream delay
    the input ``delay``, (B,) int32, each read as it stands at each
    replay.
    """

    def __init__(self, geo: apm.ApmGeometry, state: apm.ApmState):
        dev = _card_of(state)
        _check_even(state)
        untie(state)
        self.state, self.device = state, dev
        self.module = apm.module_for(geo, dev)
        B = state.frame_parity.shape[0]
        f32 = dict(dtype=torch.float32, device=dev)
        self.render = torch.zeros(
            (B, geo.render_input_rate // 100, geo.num_render_channels), **f32)
        self.capture = torch.zeros(
            (B, geo.capture_input_rate // 100, geo.num_capture_channels),
            **f32)
        self.volume = _volume_input(geo, B, dev)
        self.delay = _delay_input(geo, B, dev)
        self.period = apm.parity_period(geo)
        self.stream = torch.cuda.Stream(dev)
        self.graphs = None
        self.capture_seconds = None
        _warm_up(self.stream, state, self._warm_body)

    def _body(self, state):
        return frame_body(self.module, state, self.render, self.capture,
                          self.volume, self.delay)

    def _warm_body(self, scratch):
        for _ in range(self.period):  # every frame of the period
            self._body(scratch)
            scratch.frame_counter += 1

    def capture_graphs(self) -> None:
        """Record each frame of the period in turn, from the state's own;
        nothing runs and the state stays as it is."""
        if self.graphs is not None:
            raise RuntimeError("the frame step is captured already")
        _check_even(self.state)
        self.graphs, self.capture_seconds = _capture_in_turn(
            self.stream, self.state, 1, self.period, self.period,
            lambda: self._body(self.state))

    def replay(self, capture, render):
        """Copy a frame into the graphs' inputs and replay the graph of the
        state's frame in the period. Returns its (out, render_out, stats),
        tensors the graph owns: copy out what you keep before that graph
        replays again."""
        if self.graphs is None:
            raise RuntimeError("capture_graphs() before replaying")
        self.capture.copy_(capture, non_blocking=True)
        self.render.copy_(render, non_blocking=True)
        graph, outputs = self.graphs[self.state.frame_counter % self.period]
        graph.replay()
        self.state.frame_counter += 1
        return outputs
