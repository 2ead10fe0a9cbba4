"""Entry points: a one-stream check and the multi-GPU dry run.

The port's counterpart of the repository's ``__graft_entry__.py``. Both
drive the serving step, ``apm.process_stream_pair`` (a render and a
capture frame a call; HPF, AEC3, NS and AGC2 with the RNN-VAD), two frames
a step so that AEC3's 80 <-> 64 rebuffering keeps its static cadence (5
blocks a pair):

- ``entry(device)``: the 16 kHz mono full-APM pair step of one stream;
- ``dryrun_multigpu(n_shards, devices)``: the 48 kHz stereo full-APM step
  (three-band split, multichannel AEC3) with the stream batch split into
  shards, one a listed device (round-robin over the cards by default),
  each shard's pair step captured as its own CUDA graph
  (``step_graph.PairGraph``) and replayed on its own CUDA stream under
  ``torch.cuda.device``. The streams are independent, so there are no
  collectives: the shards' outputs are gathered. With one card every
  shard lies on it, and the run is a dry run, as the JAX one is on
  virtual CPU devices. On CPU devices the shards step eagerly.
"""

from __future__ import annotations

import numpy as np
import torch

from webrtc_audio_processing_tpu_torch import apm, config as cfg_mod
from webrtc_audio_processing_tpu_torch import step_graph
from webrtc_audio_processing_tpu_torch.ops import batch as batch_ops

RATE, CAP, REN = 48000, 2, 2


def geometry(rate: int, cap_ch: int, ren_ch: int,
             max_internal: int) -> apm.ApmGeometry:
    """``__graft_entry__._build``'s configuration: HPF, AEC3 (multichannel
    on stereo render), NS, AGC2 with adaptive digital gain."""
    c = cfg_mod.Config().replace(
        pipeline=cfg_mod.Pipeline(
            multi_channel_capture=cap_ch > 1,
            multi_channel_render=ren_ch > 1,
            maximum_internal_processing_rate=max_internal),
        high_pass_filter=cfg_mod.HighPassFilter(enabled=True),
        echo_canceller=cfg_mod.EchoCanceller(enabled=True),
        noise_suppression=cfg_mod.NoiseSuppression(enabled=True),
        gain_controller2=cfg_mod.GainController2(
            enabled=True,
            adaptive_digital=cfg_mod.AdaptiveDigital(enabled=True)),
    )
    return apm.ApmGeometry.create(
        c, rate, cap_ch, render_input_rate=rate, num_render_channels=ren_ch,
        aec3_stereo_content=ren_ch > 1)


def build(rate: int, cap_ch: int, ren_ch: int, max_internal: int, device):
    """The full-APM pair step (``__graft_entry__._build``'s wiring).

    Returns (init, pair_step, frame): ``init(batch)`` is the state of
    ``batch`` streams on ``device``; ``pair_step(state, r0, c0, r1, c1)``
    runs frames 0 and 1 of a pair ((B, frame, channels) each) on the state
    in place and returns (state, the second frame's output)."""
    geo = geometry(rate, cap_ch, ren_ch, max_internal)

    def init(batch: int = 1):
        return apm.init_state(geo, batch, device)

    def pair_step(state, r0, c0, r1, c1):
        _, (y1, _, _) = step_graph.step_pair(geo, state, r0, c0, r1, c1)
        return state, y1

    return init, pair_step, rate // 100


def entry(device=None):
    """(fn, example_args) for the 16 kHz mono full-APM pair step of one
    stream on ``device`` (the card unless the caller asks for the CPU)."""
    device = apm._resolve_device(device)
    init, pair_step, frame = build(16000, 1, 1, 32000, device)
    rng = np.random.default_rng(0)

    def mk():
        return torch.from_numpy(
            rng.standard_normal((1, frame, 1)).astype(np.float32)
            * 0.03).to(device)

    return pair_step, (init(1), mk(), mk(), mk(), mk())


# ------------------------------------------------------------ shards


def shard_bounds(batch: int, n: int) -> list[tuple[int, int]]:
    """The [start, stop) streams of each of ``n`` shards of ``batch``, as
    ``np.array_split`` cuts them."""
    edges = np.cumsum([0] + [len(a) for a in np.array_split(
        np.arange(batch), n)])
    return list(zip(edges[:-1].tolist(), edges[1:].tolist()))


def _split(node, bounds, devices):
    """``node``'s leaves cut along the batch: one node a shard."""
    if node is None or isinstance(node, int):
        return [node] * len(bounds)
    kids = batch_ops.children(node)
    if kids is not None:
        parts = {k: _split(v, bounds, devices) for k, v in kids}
        return [batch_ops.rebuild(node, {k: p[i] for k, p in parts.items()})
                for i in range(len(bounds))]
    if node.dim() == 0:  # AEC3's block ordinal, uniform across the batch
        return [node.to(d, copy=True) for d in devices]
    return [node[a:b].to(d, copy=True) for (a, b), d in zip(bounds, devices)]


def shard_state(state, devices) -> list:
    """Split a (B, ...) state along the batch into one shard per entry of
    ``devices`` (a device may repeat), each shard's leaves copies on its
    device; a plain int (the frame counter) is carried to each."""
    devices = [torch.device(d) for d in devices]
    batch = state.frame_parity.shape[0]
    if len(devices) > batch:
        raise ValueError(f"{len(devices)} shards of {batch} streams")
    return _split(state, shard_bounds(batch, len(devices)), devices)


def _join(nodes, device):
    first = nodes[0]
    if first is None or isinstance(first, int):
        if any(n != first for n in nodes):
            raise ValueError(f"the shards disagree: {nodes}")
        return first
    kids = batch_ops.children(first)
    if kids is not None:
        others = [dict(batch_ops.children(n)) for n in nodes]
        return batch_ops.rebuild(first, {
            k: _join([o[k] for o in others], device) for k, _ in kids})
    if first.dim() == 0:
        return first.to(device, copy=True)
    if first.dtype == torch.uint32:  # CUDA concatenates no uint32
        return torch.cat([n.to(device).to(torch.int64) for n in nodes]).to(
            torch.uint32)
    return torch.cat([n.to(device) for n in nodes])


def gather_state(shards: list):
    """Join shards (``shard_state``'s order) back into one (B, ...) state
    on the first shard's device."""
    return _join(shards, shards[0].frame_parity.device)


class ShardedPairStep:
    """The pair step of ``geo`` over a (B, ...) state cut into one shard
    per entry of ``devices``, which the shards own from here on.

    On CUDA devices each shard is a ``step_graph.PairGraph`` built, and
    later replayed, under ``torch.cuda.device`` of its card on its own
    CUDA stream; ``capture()`` records them all. On the CPU each shard
    steps eagerly (``step_graph.step_pair``). ``step`` takes a pair's
    frames of all B streams, (B, frame, channels) each on any device, and
    returns each frame's (out, render_out) gathered on the first shard's
    device, ``out_device``."""

    def __init__(self, geo: apm.ApmGeometry, state, devices):
        self.geo = geo
        self.devices = [torch.device(d) for d in devices]
        if len({d.type for d in self.devices}) != 1:
            raise ValueError("shards on CUDA and CPU devices at once")
        self.cuda = self.devices[0].type == "cuda"
        self.batch = state.frame_parity.shape[0]
        self.bounds = shard_bounds(self.batch, len(self.devices))
        self.out_device = self.devices[0]
        self.shards = shard_state(state, self.devices)
        self.graphs = None
        self.capture_seconds = None
        if self.cuda:
            self.graphs = []
            for d, st in zip(self.devices, self.shards):
                with torch.cuda.device(d):
                    self.graphs.append(step_graph.PairGraph(geo, st))

    def capture(self) -> None:
        """Capture every shard's pair graph; their capture seconds
        summed."""
        if not self.cuda:
            return
        for d, g in zip(self.devices, self.graphs):
            with torch.cuda.device(d):
                g.capture()
        self.capture_seconds = sum(g.capture_seconds for g in self.graphs)

    def step(self, r0, c0, r1, c1):
        cut = [tuple(x[a:b] for x in (r0, c0, r1, c1))
               for a, b in self.bounds]
        if not self.cuda:
            outs = [step_graph.step_pair(self.geo, st, *(
                x.to(d) for x in frames))
                for d, st, frames in zip(self.devices, self.shards, cut)]
        else:
            outs = []
            for d, g, frames in zip(self.devices, self.graphs, cut):
                with torch.cuda.device(d):
                    # The shard's stream waits for the caller's work on
                    # the inputs; the replay's copies read them there.
                    g.stream.wait_stream(torch.cuda.current_stream(d))
                    with torch.cuda.stream(g.stream):
                        outs.append(g.replay(*frames))
            for g in self.graphs:
                torch.cuda.current_stream(self.out_device).wait_stream(
                    g.stream)
        return tuple(
            tuple(torch.cat([o[f][i].to(self.out_device) for o in outs])
                  for i in (0, 1))
            for f in (0, 1))

    def state(self):
        """The shards' state gathered on ``out_device``; the shards keep
        theirs."""
        if self.cuda:
            for g in self.graphs:
                torch.cuda.current_stream(self.out_device).wait_stream(
                    g.stream)
        return gather_state(self.shards)


def default_devices(n_shards: int) -> list[torch.device]:
    """The cards round-robin, one a shard; raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the multi-GPU dry run needs a CUDA device; pass devices="
            "[\"cpu\"] * n to run the shards on the CPU")
    n = torch.cuda.device_count()
    return [torch.device("cuda", i % n) for i in range(n_shards)]


def dryrun_multigpu(n_shards: int, devices=None, batch: int | None = None,
                    frames=None):
    """Split the 48 kHz stereo full-APM serving step over ``n_shards``
    shards (on ``devices``, the cards round-robin by default) and run one
    pair step of ``batch`` streams (``2 * n_shards`` by default, as the JAX
    dry run) from ``init_state``. ``frames``: the pair's (r0, c0, r1, c1),
    (B, 480, 2) each; seeded noise by default. Prints the shards, their
    devices and B; returns the runner (its shards one pair on, ready for
    more) and the pair's ((out, render_out) of each frame), gathered on the
    first shard's device."""
    devices = (default_devices(n_shards) if devices is None
               else [torch.device(d) for d in devices])
    if len(devices) != n_shards:
        raise ValueError(f"{n_shards} shards need {n_shards} devices, got "
                         f"{len(devices)}")
    batch = batch or 2 * n_shards
    geo = geometry(RATE, CAP, REN, 48000)
    runner = ShardedPairStep(geo, apm.init_state(geo, batch, devices[0]),
                             devices)
    runner.capture()
    frame = RATE // 100
    if frames is None:
        rng = np.random.default_rng(0)
        frames = [torch.from_numpy(rng.standard_normal(
            (batch, frame, ch)).astype(np.float32) * 0.03).to(devices[0])
            for ch in (REN, CAP, REN, CAP)]
    outs = runner.step(*frames)
    if runner.cuda:
        torch.cuda.synchronize(runner.out_device)
    y = outs[1][0]
    if tuple(y.shape) != (batch, frame, CAP):
        raise AssertionError(f"output shape {tuple(y.shape)}")
    print(f"dryrun_multigpu OK: {n_shards} shards on "
          f"{[str(d) for d in devices]}, batch {batch}, 48 kHz stereo "
          f"full-APM pair step, out {tuple(y.shape)}", flush=True)
    return runner, outs
