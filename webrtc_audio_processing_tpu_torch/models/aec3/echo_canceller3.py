"""EchoCanceller3: frame-level AEC3 with its block pipeline.

Port of ``webrtc_audio_processing_tpu/models/aec3/echo_canceller3.py``
(reference: aec3/echo_canceller3.cc, aec3/block_processor.cc,
aec3/frame_blocker.cc, aec3/block_framer.cc). One step takes a paired
render and capture frame; the 2-or-3 blocks-per-frame cadence is the static
frame parity, a Python int (it fixes the frame's block count, a static
shape); the ring write positions follow the block ordinal ``n0``, a 0-d
int32 tensor on the state's device, both uniform across the batch.

Two capture paths, as in the JAX twin. The pair-phase path
(``pair_phase=True``, the default) runs the delay stack for every block of
the frame first, then the echo remover's three-phase pair form; its
subtractor is the plain ``subtractor.process_pair`` by default, or the pair
kernel K6 with ``pair_kernel=True`` where the coarse filter has no more
partitions than the refined one; with a longer coarse filter the pair path
runs the plain subtractor, as the JAX twin does (see
``echo_remover.process_capture_pair``).
The per-block path (``pair_phase=False``, the JAX package's
``AEC3_PAIR_PHASE=0``) runs each block through the whole of
BlockProcessor::ProcessCapture in the reference's order, with no pair-phase
staleness; K6 computes the pair form only, so ``pair_kernel`` with it
raises. The geometry takes the choices as arguments only; a script that
follows the JAX package's ``AEC3_PAIR_KERNEL`` switch reads it with
``pair_kernel_from_env``.

With ``fixed_capture_delay_samples > 0`` in the config, the capture runs
through a fixed pre-delay line per split band before blocking
(block_delay_buffer.cc). An injected neural residual echo estimator
(``nree``, builder.NeuralResidualEchoEstimator) replaces the residual
echo estimate on every block. With ``debug_taps``, ``process_frame`` also
returns the last block's named internals (the ApmDataDumper analog).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass

import torch

from webrtc_audio_processing_tpu_torch.models.aec3 import (
    delay_estimator as de,
    echo_remover as er,
    multi_channel_content_detector as mccd,
    render_buffer as rb,
)
from webrtc_audio_processing_tpu_torch.models.aec3.config import (
    EchoCanceller3Config,
)
from webrtc_audio_processing_tpu_torch.ops.batch import tree_where

BLOCK_SIZE = 64
FRAME_SIZE = 160


def pair_kernel_from_env() -> bool:
    """The JAX package's ``AEC3_PAIR_KERNEL`` switch
    (webrtc_audio_processing_tpu/models/aec3/echo_canceller3.py:75-83): on
    only for exactly "1", off when unset."""
    return os.environ.get("AEC3_PAIR_KERNEL", "0") == "1"


def pair_phase_from_env() -> bool:
    """The JAX package's ``AEC3_PAIR_PHASE`` switch
    (webrtc_audio_processing_tpu/models/aec3/echo_canceller3.py:72-73): the
    pair-phase path unless it is exactly "0"."""
    return os.environ.get("AEC3_PAIR_PHASE", "1") != "0"


@dataclass(frozen=True)
class Aec3Geometry:
    config: EchoCanceller3Config
    sample_rate_hz: int
    num_bands: int
    num_render_channels: int
    num_capture_channels: int
    buffer: rb.BufferGeometry
    delay: de.DelayGeometry
    # The injected neural residual echo estimator
    # (builder.NeuralResidualEchoEstimator); None: the model-based one.
    nree: object | None = None
    # process_frame also returns the last block's named internals.
    debug_taps: bool = False
    # The pair-phase capture path; False: the per-block path.
    pair_phase: bool = True
    # The subtractor on the pair kernel K6 (ops/cuda_subtractor.py).
    pair_kernel: bool = False

    @staticmethod
    def create(config: EchoCanceller3Config, sample_rate_hz: int,
               num_render: int, num_capture: int,
               nree: object | None = None,
               debug_taps: bool = False,
               ring_dtype: str = "float32",
               pair_phase: bool = True,
               pair_kernel: bool = False) -> "Aec3Geometry":
        if pair_kernel and not pair_phase:
            # The JAX twin ignores the flag there; the port does not run
            # the plain subtractor on the card in its place.
            raise ValueError("the pair kernel K6 computes the pair-phase "
                             "form only; pair_kernel needs pair_phase")
        return Aec3Geometry(
            config=config,
            sample_rate_hz=sample_rate_hz,
            num_bands=sample_rate_hz // 16000,
            num_render_channels=num_render,
            num_capture_channels=num_capture,
            buffer=rb.BufferGeometry.create(config, sample_rate_hz,
                                            num_render,
                                            ring_dtype=ring_dtype),
            delay=de.DelayGeometry.create(config),
            nree=nree,
            debug_taps=debug_taps,
            pair_phase=pair_phase,
            pair_kernel=pair_kernel,
        )


@dataclass
class EchoCanceller3State:
    buffer: rb.RenderDelayBufferState
    delay: de.DelayEstimatorState
    remover: er.EchoRemoverState
    # BlockProcessor flags (block_processor.cc).
    capture_started: torch.Tensor  # (B,) bool
    render_event_pending: torch.Tensor  # (B,) int32
    # Frame <-> block rebuffering carries.
    render_blocker_carry: torch.Tensor  # (B, bands, 32, C_ren)
    capture_blocker_carry: torch.Tensor  # (B, bands, 32, C_cap)
    output_framer_carry: torch.Tensor  # (B, bands, 64, C_cap)
    linear_framer_carry: torch.Tensor  # (B, 64, C_cap)
    saturated_microphone: torch.Tensor  # (B,) bool
    mc_detector: mccd.MultiChannelContentDetectorState
    mc_config_changed: torch.Tensor  # (B,) bool: the host re-creates
    # BlockDelayBuffer (block_delay_buffer.cc): the fixed capture pre-delay
    # line, (B, bands, fixed_capture_delay_samples, C_cap); width 0 when off.
    capture_predelay: torch.Tensor

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def init_state(geo: Aec3Geometry, batch: int, device) -> EchoCanceller3State:
    f32 = dict(dtype=torch.float32, device=device)
    nb, cr, cc = geo.num_bands, geo.num_render_channels, \
        geo.num_capture_channels
    return EchoCanceller3State(
        buffer=rb.init_state(geo.buffer, geo.config, batch, device),
        delay=de.init_state(geo.delay, geo.config, cc, batch, device),
        remover=er.init_state(geo.config, nb, cr, cc, batch, device),
        capture_started=torch.zeros((batch,), dtype=torch.bool,
                                    device=device),
        render_event_pending=torch.zeros((batch,), dtype=torch.int32,
                                         device=device),
        render_blocker_carry=torch.zeros((batch, nb, 32, cr), **f32),
        capture_blocker_carry=torch.zeros((batch, nb, 32, cc), **f32),
        output_framer_carry=torch.zeros((batch, nb, BLOCK_SIZE, cc), **f32),
        linear_framer_carry=torch.zeros((batch, BLOCK_SIZE, cc), **f32),
        saturated_microphone=torch.zeros((batch,), dtype=torch.bool,
                                         device=device),
        mc_detector=mccd.init_state(
            geo.config.multi_channel.detect_stereo_content, cr, batch,
            device),
        mc_config_changed=torch.zeros((batch,), dtype=torch.bool,
                                      device=device),
        capture_predelay=torch.zeros(
            (batch, nb, geo.config.delay.fixed_capture_delay_samples, cc),
            **f32),
    )


def _split_blocks(frame, carry, parity: int):
    """FrameBlocker block extraction for one 160-sample frame.

    frame: (B, bands, 160, C); carry: (B, bands, 32, C), valid entering odd
    frames. Returns (blocks list, new_carry)."""
    if parity == 0:
        return [frame[:, :, 0:64], frame[:, :, 64:128]], frame[:, :, 128:160]
    blocks = [torch.cat([carry, frame[:, :, 0:32]], dim=2),
              frame[:, :, 32:96], frame[:, :, 96:160]]
    return blocks, torch.zeros_like(carry)


def _frame_from_blocks(blocks, carry, parity: int):
    """BlockFramer sub-frame extraction (block_framer.cc).

    blocks: list of (B, bands, 64, C); carry (B, bands, 64, C) with a valid
    prefix of 64 entering even frames and 32 entering odd frames. Returns
    (frame (B, bands, 160, C), new_carry)."""
    if parity == 0:
        b1, b2 = blocks
        frame = torch.cat([carry, b1, b2[:, :, 0:32]], dim=2)
        new_carry = torch.cat([b2[:, :, 32:64],
                               torch.zeros_like(b2[:, :, 0:32])], dim=2)
        return frame, new_carry
    b1, b2, b3 = blocks
    return torch.cat([carry[:, :, 0:32], b1, b2], dim=2), b3


def _delay_phase_block(geo: Aec3Geometry, state: EchoCanceller3State,
                       capture_block, n: torch.Tensor):
    """The delay-stack part of BlockProcessorImpl::ProcessCapture
    (block_processor.cc:84-174) for one capture block (B, bands, 64, C):
    first-capture reset, render overrun flush, buffer events, delay
    estimation and ring alignment. Returns (state, delay_change, est_delay,
    est_valid), each (B,)."""
    cfg = geo.config
    # First-capture reset (block_processor.cc:102-113), a per-stream select.
    first = ~state.capture_started
    buffer = tree_where(first, rb.reset(geo.buffer, cfg, state.buffer),
                        state.buffer)
    # Render overrun flush (block_processor.cc:119-127).
    flush = state.render_event_pending == rb.EVENT_RENDER_OVERRUN
    buffer, buf_event, _activity = rb.prepare_capture_processing(
        geo.buffer, cfg, buffer)
    underrun = buf_event == rb.EVENT_RENDER_UNDERRUN

    # One combined delay-controller reset select: reset fields are constants
    # except the confidence-gated ones, so the three resets compose.
    hard = first | flush
    delay_state = tree_where(hard | underrun,
                             de.reset_delay_controller(state.delay, hard),
                             state.delay)

    delay_state, est_delay, est_valid = de.get_delay(
        geo.delay, cfg, delay_state, buffer.lowrate,
        rb.lr_read_index(geo.buffer, buffer, n), capture_block)
    buffer, changed = rb.align_from_delay(geo.buffer, cfg, buffer, est_delay)
    # AlignFromDelay is a no-op when no estimate exists yet.
    delay_change = flush | (changed & est_valid)
    new_state = state.replace(
        buffer=buffer,
        delay=delay_state,
        capture_started=torch.ones_like(state.capture_started),
        render_event_pending=torch.zeros_like(state.render_event_pending),
    )
    return new_state, delay_change, est_delay, est_valid


def _detect_saturation(y):
    """DetectSaturation (echo_canceller3.cc:48-56): any |y| >= 32700."""
    return torch.any((torch.abs(y) >= 32700.0).flatten(1), dim=1)


def _process_capture_block(geo: Aec3Geometry, state: EchoCanceller3State,
                           capture_block, echo_path_gain_change,
                           n: torch.Tensor, pending_count: int):
    """BlockProcessorImpl::ProcessCapture (block_processor.cc:84-200) for
    one capture block (B, bands, 64, C): the delay stack, then the echo
    remover's per-block form. Returns (state, out_block, linear (B, C, 64),
    taps or None)."""
    state, delay_change, est_delay, est_valid = _delay_phase_block(
        geo, state, capture_block, n)
    taps = {} if geo.debug_taps else None
    remover, out_block, linear = er.process_capture(
        geo.config, state.remover, geo.buffer,
        rb.RenderView(state.buffer, n, pending_count), capture_block,
        delay_change, echo_path_gain_change, state.saturated_microphone,
        est_delay, est_valid, nree=geo.nree, taps=taps)
    return state.replace(remover=remover), out_block, linear, taps


def process_frame(geo: Aec3Geometry, state: EchoCanceller3State,
                  render_frame, capture_frame, parity: int,
                  n0: torch.Tensor):
    """One paired 10 ms frame through the AEC3 block pipeline
    (EchoCanceller3::ProcessCapture, echo_canceller3.cc:876-939, with the
    render queue collapsed into the same step).

    render_frame (B, bands, 160, C_ren), capture_frame (B, bands, 160,
    C_cap) in floatS16; ``parity`` the frame's parity (a Python int) and
    ``n0`` the number of blocks inserted before it (a 0-d int32 tensor).
    The render rings are updated in place. Returns (state, out_frame (B,
    bands, 160, C_cap), linear_frame (B, 160, C_cap)), and with
    ``debug_taps`` the last block's taps, {name: (B, ...)}, fourth."""
    cfg = geo.config
    # AnalyzeCapture saturation scan (echo_canceller3.cc:862-874).
    state = state.replace(
        saturated_microphone=_detect_saturation(capture_frame[:, 0]))
    # The fixed capture pre-delay (echo_canceller3.cc:902-906,
    # block_delay_buffer.cc): a D-sample delay line per split band, after
    # the undelayed saturation scan and before blocking.
    if cfg.delay.fixed_capture_delay_samples > 0:
        cat = torch.cat([state.capture_predelay, capture_frame], dim=2)
        capture_frame = cat[:, :, :FRAME_SIZE]
        state = state.replace(capture_predelay=cat[:, :, FRAME_SIZE:])

    # Stereo-content detection on the render frame (:969-1005).
    mc = cfg.multi_channel
    mc_state, mc_changed = mccd.update(
        state.mc_detector, render_frame, mc.detect_stereo_content,
        mc.stereo_detection_threshold,
        mc.stereo_detection_timeout_threshold_seconds,
        mc.stereo_detection_hysteresis_seconds)
    state = state.replace(mc_detector=mc_state, mc_config_changed=mc_changed)
    # Mono fallback downmix (BufferRenderFrameContent via FillSubFrameView,
    # echo_canceller3.cc:120-155): a mono canceller on a multichannel render
    # averages the channels while temporary multichannel content is present
    # and takes channel 0 otherwise; the choice is made per stream on the
    # device, so the step stays capturable.
    if render_frame.shape[-1] > geo.num_render_channels:
        if geo.num_render_channels != 1:
            raise ValueError("a partial render downmix is not a reference "
                             "behavior")
        avg = torch.mean(render_frame, dim=-1, keepdim=True)
        render_frame = torch.where(
            mc_state.temporary_detected[:, None, None, None], avg,
            render_frame[..., :1])

    # Render side: block and insert; the previous pair's staged rows are
    # flushed at the start of each even frame.
    r_blocks, r_carry = _split_blocks(render_frame,
                                      state.render_blocker_carry, parity)
    buffer = state.buffer
    event = state.render_event_pending
    if parity == 0:
        buffer = rb.flush_sf_pending(geo.buffer, buffer, n0)
    slot_base = 0 if parity == 0 else rb.PAIR_BLOCKS - len(r_blocks)
    for k, blk in enumerate(r_blocks):
        buffer, ev = rb.insert(geo.buffer, cfg, buffer, blk, n0 + k + 1,
                               sf_slot=slot_base + k)
        event = torch.maximum(event, ev)
    state = state.replace(buffer=buffer, render_blocker_carry=r_carry,
                          render_event_pending=event)
    n = n0 + len(r_blocks)

    # Capture side: block, process, reframe.
    c_blocks, c_carry = _split_blocks(capture_frame,
                                      state.capture_blocker_carry, parity)
    pending_count = 2 if parity == 0 else rb.PAIR_BLOCKS
    level_change = torch.zeros_like(state.saturated_microphone)
    taps = None
    if geo.pair_phase:
        # The delay stack for every block, then the echo remover's
        # three-phase pair form.
        views, dchanges, edelays, evalids = [], [], [], []
        for blk in c_blocks:
            state, dch, edl, evl = _delay_phase_block(geo, state, blk, n)
            views.append(rb.RenderView(state.buffer, n, pending_count))
            dchanges.append(dch)
            edelays.append(edl)
            evalids.append(evl)
        taps = {} if geo.debug_taps else None
        remover, outs, linears = er.process_capture_pair(
            cfg, state.remover, geo.buffer, views, c_blocks, dchanges,
            level_change, state.saturated_microphone, edelays, evalids,
            pair_kernel=geo.pair_kernel, nree=geo.nree, taps=taps)
        state = state.replace(remover=remover)
    else:
        # Each block through the whole block processor in turn.
        outs, linears = [], []
        for blk in c_blocks:
            state, out_blk, linear, taps = _process_capture_block(
                geo, state, blk, level_change, n, pending_count)
            outs.append(out_blk)
            linears.append(linear)

    out_frame, out_carry = _frame_from_blocks(
        outs, state.output_framer_carry, parity)
    linear_frame, linear_carry = _frame_from_blocks(
        [e.transpose(1, 2)[:, None] for e in linears],
        state.linear_framer_carry[:, None], parity)
    state = state.replace(
        capture_blocker_carry=c_carry,
        output_framer_carry=out_carry,
        linear_framer_carry=linear_carry[:, 0],
    )
    if geo.debug_taps:
        return state, out_frame, linear_frame[:, 0], taps
    return state, out_frame, linear_frame[:, 0]


def get_metrics(geo: Aec3Geometry, state: EchoCanceller3State) -> dict:
    """EchoCanceller3::GetMetrics via the echo remover (echo_remover.cc:228)
    and the host-side reporter inputs, each (B,)."""
    aec = state.remover.aec
    erl_td = aec.erl.erl_time_domain
    erle_log2 = torch.mean(aec.erle.fullband.erle_time_domain_log2, dim=1)
    return {
        "echo_return_loss": -10.0 * torch.log10(
            torch.clamp(erl_td, min=1e-10)),
        "echo_return_loss_enhancement": erle_log2 * (10.0 * 0.30102999566),
        "delay_ms": rb.compute_delay(geo.buffer, state.buffer) * 4,
        "multichannel_content_detected":
            state.mc_detector.persistent_detected,
        "multichannel_config_changed": state.mc_config_changed,
        "aec3_erl_time_domain": erl_td,
        "aec3_erle_fullband_log2": erle_log2,
        "aec3_divergent_filter_fraction": aec.divergent_fraction,
        "aec3_usable_linear_estimate": aec.usable_linear_estimate,
        "aec3_saturated_capture": aec.capture_signal_saturation,
        "aec3_min_filter_delay": aec.min_filter_delay,
        "aec3_external_delay_valid": aec.external_delay_valid,
        "aec3_clockdrift_level": state.delay.clockdrift.level,
    }


class EchoControl:
    """This AEC3 behind the EchoControl surface (api/audio/echo_control.h)
    that an injected ``builder.EchoControlFactory`` returns: ``init_state``,
    ``process_frame(state, render_bands, capture_bands, parity)`` and
    ``get_metrics``. Its state is {"aec": EchoCanceller3State, "n0": (B,)
    int32}, the block ordinal kept per stream (uniform across the batch)
    and advanced on the device, so the frames need nothing else."""

    def __init__(self, geo: Aec3Geometry):
        self.geo = geo

    def init_state(self, batch: int, device) -> dict:
        return {"aec": init_state(self.geo, batch, device),
                "n0": torch.zeros((batch,), dtype=torch.int32,
                                  device=device)}

    def process_frame(self, state: dict, render_bands, capture_bands,
                      parity: int):
        aec, out, linear = process_frame(
            self.geo, state["aec"], render_bands, capture_bands, parity,
            state["n0"][0])[:3]
        return ({"aec": aec, "n0": state["n0"] + (3 if parity else 2)},
                out, linear)

    def get_metrics(self, state: dict) -> dict:
        return get_metrics(self.geo, state["aec"])
