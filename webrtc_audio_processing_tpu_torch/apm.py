"""AudioProcessing: the top-level APM pipeline, batched over streams.

Port of ``webrtc_audio_processing_tpu/apm.py`` for the capture chain without
an echo canceller (reference: audio_processing_impl.cc,
ProcessCaptureStreamLocked :1264-1561 and ProcessRenderStreamLocked
:1653-1687): AudioBuffer copy-in, full-band HPF, input RMS, band split,
NS analyze and process, band merge, AGC2 with the internal RNN-VAD, output
RMS, copy-out. The render side splits, merges and copies back.

Usage, with B streams on one device::

    geo = ApmGeometry.create(config, 48000, 2, num_render_channels=2)
    state = init_state(geo, batch=B, device="cuda")
    state, out, render_out, stats = process_stream_pair(
        geo, state, capture, render)   # capture, render: (B, 480, C)

``Apm(geo)`` is the ``nn.Module`` behind ``process_stream_pair``; the
functions keep one per geometry and device. Everything outside this chain
raises ``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from webrtc_audio_processing_tpu_torch import config as cfg_mod
from webrtc_audio_processing_tpu_torch.models import (
    audio_buffer,
    high_pass_filter as hpf,
    noise_suppressor as ns,
    rms_level,
)
from webrtc_audio_processing_tpu_torch.models.agc2 import (
    gain_controller2 as gc2,
)


def suitable_process_rate(minimum_rate: int, max_splitting_rate: int,
                          band_splitting_required: bool) -> int:
    """SuitableProcessRate (audio_processing_impl.cc:92-107)."""
    uppermost = max_splitting_rate if band_splitting_required else 48000
    for rate in (16000, 32000, 48000):
        if rate >= uppermost:
            return uppermost
        if rate >= minimum_rate:
            return rate
    return uppermost


def _check_supported(config: cfg_mod.Config) -> None:
    """Raise for every part of the config this port does not run yet."""
    unported = [
        (config.echo_canceller.enabled and not config.echo_canceller.mobile_mode,
         "the echo canceller AEC3, with its echo detector and 48 kHz "
         "PostFilter (ROADMAP Queue 1 items 3 and 6-10)"),
        (config.echo_canceller.enabled and config.echo_canceller.mobile_mode,
         "the mobile echo canceller AECM (ROADMAP Queue 1 item 13)"),
        (config.gain_controller1.enabled,
         "AGC1 (ROADMAP Queue 1 item 13)"),
        (config.capture_level_adjustment.enabled,
         "the capture levels adjuster (ROADMAP Queue 1 item 12)"),
        (config.pre_amplifier.enabled,
         "the pre-amplifier (ROADMAP Queue 1 item 12)"),
        ((config.high_pass_filter.enabled or config.noise_suppression.enabled)
         and not config.high_pass_filter.apply_in_full_band,
         "the split-band HPF (ROADMAP Queue 1 item 11)"),
        (config.gain_controller2.input_volume_controller.enabled,
         "the AGC2 input volume controller (ROADMAP Queue 1 item 12)"),
    ]
    for bad, what in unported:
        if bad:
            raise NotImplementedError(f"{what} is not ported yet")


@dataclass(frozen=True)
class ApmGeometry:
    """Static processing formats (InitializeLocked, :558-692)."""

    config: cfg_mod.Config
    capture_input_rate: int
    capture_output_rate: int
    render_input_rate: int
    render_output_rate: int
    num_capture_channels: int
    num_render_channels: int
    capture_processing_rate: int
    render_processing_rate: int
    render_processing_channels: int

    @staticmethod
    def create(
        config: cfg_mod.Config,
        capture_input_rate: int,
        num_capture_channels: int = 1,
        capture_output_rate: int | None = None,
        render_input_rate: int | None = None,
        num_render_channels: int = 1,
        render_output_rate: int | None = None,
        injections: object | None = None,
    ) -> "ApmGeometry":
        if injections is not None:
            raise NotImplementedError(
                "builder injections are not ported yet (ROADMAP Queue 1 "
                "item 12)"
            )
        _check_supported(config)
        capture_output_rate = capture_output_rate or capture_input_rate
        render_input_rate = render_input_rate or capture_input_rate
        render_output_rate = render_output_rate or render_input_rate

        multiband = (
            config.noise_suppression.enabled
            or config.echo_canceller.enabled
            or config.gain_controller1.enabled
            or (config.high_pass_filter.enabled
                and not config.high_pass_filter.apply_in_full_band)
        )
        max_split = (
            config.pipeline.maximum_internal_processing_rate
            if config.pipeline.maximum_internal_processing_rate == 32000
            else 48000
        )
        cap_rate = suitable_process_rate(
            min(capture_input_rate, capture_output_rate), max_split, multiband
        )
        ren_rate = suitable_process_rate(
            min(render_input_rate, render_output_rate), max_split, multiband
        )
        ren_channels = (num_render_channels
                        if config.pipeline.multi_channel_render else 1)
        return ApmGeometry(
            config=config,
            capture_input_rate=capture_input_rate,
            capture_output_rate=capture_output_rate,
            render_input_rate=render_input_rate,
            render_output_rate=render_output_rate,
            num_capture_channels=num_capture_channels,
            num_render_channels=num_render_channels,
            capture_processing_rate=cap_rate,
            render_processing_rate=ren_rate,
            render_processing_channels=ren_channels,
        )

    @property
    def capture_processing_channels(self) -> int:
        # No echo controller runs, so capture is never narrowed to mono
        # (audio_processing_impl.cc:798-806).
        return self.num_capture_channels

    @property
    def hpf_enabled(self) -> bool:
        """HighPassFilteringRequired (audio_processing_impl.cc:439-442)
        without the echo-canceller terms."""
        c = self.config
        return c.high_pass_filter.enabled or c.noise_suppression.enabled

    @property
    def hpf_rate(self) -> int:
        """The full-band HPF selects coefficients at the 48 kHz output rate
        when processing runs below it (the reference's quirky pairing,
        audio_processing_impl.cc:1282-1287, :1891-1896)."""
        if (self.capture_output_rate == 48000
                and self.capture_processing_rate < 48000):
            return 48000
        return self.capture_processing_rate

    def capture_buffer_config(self) -> audio_buffer.BufferConfig:
        return audio_buffer.BufferConfig(
            input_rate=self.capture_input_rate,
            input_num_channels=self.num_capture_channels,
            buffer_rate=self.capture_processing_rate,
            buffer_num_channels=self.num_capture_channels,
            output_rate=self.capture_output_rate,
            output_num_channels=self.num_capture_channels,
            downmix_method=self.config.pipeline.capture_downmix_method,
        )

    def render_buffer_config(self) -> audio_buffer.BufferConfig:
        return audio_buffer.BufferConfig(
            input_rate=self.render_input_rate,
            input_num_channels=self.num_render_channels,
            buffer_rate=self.render_processing_rate,
            buffer_num_channels=self.render_processing_channels,
            output_rate=self.render_output_rate,
            output_num_channels=self.num_render_channels,
        )


@dataclass
class ApmState:
    """The JAX ``ApmState`` fields this chain uses, leaves (B, ...)."""

    capture_buffer: audio_buffer.AudioBufferState
    render_buffer: audio_buffer.AudioBufferState
    hpf: hpf.HighPassFilterState | None
    ns: ns.NsState | None
    agc2: gc2.Agc2State | None
    input_rms: rms_level.RmsLevelState
    output_rms: rms_level.RmsLevelState
    frame_parity: torch.Tensor  # (B,) int32
    was_stream_delay_set: torch.Tensor  # (B,) bool


def init_state(geo: ApmGeometry, batch: int, device=None) -> ApmState:
    c = geo.config
    cap_cfg = geo.capture_buffer_config()
    return ApmState(
        capture_buffer=audio_buffer.init_state(cap_cfg, batch, device),
        render_buffer=audio_buffer.init_state(geo.render_buffer_config(),
                                              batch, device),
        hpf=(hpf.init_state(batch, geo.num_capture_channels, device)
             if geo.hpf_enabled else None),
        ns=(ns.init_state(batch, geo.capture_processing_channels,
                          cap_cfg.num_bands, device)
            if c.noise_suppression.enabled else None),
        agc2=(gc2.init_state(c.gain_controller2, geo.capture_processing_rate,
                             batch, device)
              if c.gain_controller2.enabled else None),
        input_rms=rms_level.init_state(batch, device),
        output_rms=rms_level.init_state(batch, device),
        frame_parity=torch.zeros(batch, dtype=torch.int32, device=device),
        was_stream_delay_set=torch.zeros(batch, dtype=torch.bool,
                                         device=device),
    )


class Apm(nn.Module):
    """The capture and render chain of one geometry; its constants are the
    registered buffers of its submodules."""

    def __init__(self, geo: ApmGeometry, raw_vad_weights: dict | None = None):
        super().__init__()
        _check_supported(geo.config)
        c = geo.config
        self.geo = geo
        self.capture_buffer = audio_buffer.AudioBuffer(
            geo.capture_buffer_config())
        self.render_buffer = audio_buffer.AudioBuffer(
            geo.render_buffer_config())
        self.hpf = (hpf.HighPassFilter(geo.hpf_rate)
                    if geo.hpf_enabled else None)
        self.ns = (ns.NoiseSuppressor(c.noise_suppression.level)
                   if c.noise_suppression.enabled else None)
        self.agc2 = (gc2.GainController2(c.gain_controller2,
                                         geo.capture_processing_rate,
                                         raw_vad_weights)
                     if c.gain_controller2.enabled else None)

    def process_render_stream(self, state: ApmState, render: torch.Tensor):
        """Render half without an echo canceller: copy in, split, merge,
        copy back (ProcessRenderStreamLocked, :1653-1687).

        Returns (state, render_out, render_bands)."""
        rb = self.render_buffer
        rbuf, r = rb.copy_from(state.render_buffer, render)
        if rb.cfg.num_bands > 1:
            rbuf, render_bands = rb.split_into_frequency_bands(rbuf, r)
            rbuf, r = rb.merge_frequency_bands(rbuf, render_bands)
        else:
            render_bands = r[:, None]
        rbuf, render_out = rb.copy_to(rbuf, r)
        return (dataclasses.replace(state, render_buffer=rbuf), render_out,
                render_bands)

    def forward(self, state: ApmState, capture: torch.Tensor,
                render: torch.Tensor | None = None):
        """One paired 10 ms step: render, then capture.

        capture: (B, capture_in_frames, C_cap), render: (B, render_in_frames,
        C_ren), both in [-1, 1]. Returns (state, capture_out, render_out,
        stats), every stats value (B,).
        """
        render_out = render
        if render is not None:
            state, render_out, _ = self.process_render_stream(state, render)

        cb = self.capture_buffer
        cbuf, y = cb.copy_from(state.capture_buffer, capture)

        # Full-band HPF (:1282-1287).
        new_hpf = state.hpf
        if self.hpf is not None:
            new_hpf, y = self.hpf(state.hpf, y)

        input_rms = rms_level.analyze(state.input_rms, y)

        # Band split (:1359-1363), NS analyze + process (:1387-1425), merge
        # (:1444-1448).
        if cb.cfg.num_bands > 1:
            cbuf, bands = cb.split_into_frequency_bands(cbuf, y)
        else:
            bands = y[:, None]
        new_ns = state.ns
        if self.ns is not None:
            new_ns, bands = self.ns(state.ns, bands)
        if cb.cfg.num_bands > 1:
            cbuf, y = cb.merge_frequency_bands(cbuf, bands)
        else:
            y = bands[:, 0]

        # AGC2 (:1472-1477).
        stats = {}
        new_agc2 = state.agc2
        if self.agc2 is not None:
            new_agc2, y, info = self.agc2(state.agc2, y)
            stats.update({f"agc2_{k}": v for k, v in info.items()})

        output_rms = rms_level.analyze(state.output_rms, y)
        cbuf, out = cb.copy_to(cbuf, y)

        state = dataclasses.replace(
            state,
            capture_buffer=cbuf,
            hpf=new_hpf,
            ns=new_ns,
            agc2=new_agc2,
            input_rms=input_rms,
            output_rms=output_rms,
            frame_parity=torch.remainder(state.frame_parity + 1, 2).to(
                torch.int32),
        )
        return state, out, render_out, stats


@functools.lru_cache(maxsize=8)
def module_for(geo: ApmGeometry, device: torch.device) -> Apm:
    """The ``Apm`` module of a geometry on a device, built once."""
    return Apm(geo).to(device)


def process_render_stream(geo: ApmGeometry, state: ApmState,
                          render: torch.Tensor):
    return module_for(geo, render.device).process_render_stream(state, render)


def process_stream_pair(geo: ApmGeometry, state: ApmState,
                        capture: torch.Tensor,
                        render: torch.Tensor | None = None):
    """One paired step for B streams; see ``Apm.forward``."""
    return module_for(geo, capture.device)(state, capture, render)


# --------------------------------------------------- state from and to JAX


def tree_to_state(template, src, path: str = "state"):
    """Fill the port state ``template`` (for structure, dtypes and trailing
    shapes) from a JAX state pytree with numpy leaves, field by field."""
    if template is None:
        if src is not None:
            raise ValueError(f"{path}: the port has no state here")
        return None
    if dataclasses.is_dataclass(template):
        out = {}
        for f in dataclasses.fields(template):
            out[f.name] = tree_to_state(getattr(template, f.name),
                                     getattr(src, f.name), f"{path}.{f.name}")
        if dataclasses.is_dataclass(src):
            extra = [f.name for f in dataclasses.fields(src)
                     if f.name not in out and getattr(src, f.name) is not None]
            if extra:
                raise ValueError(f"{path}: state the port does not run: "
                                 f"{extra}")
        return type(template)(**out)
    arr = np.asarray(src)
    if arr.shape[1:] != tuple(template.shape[1:]):
        raise ValueError(f"{path}: shape {arr.shape} does not match the "
                         f"port's (B,) + {tuple(template.shape[1:])}")
    return torch.from_numpy(np.array(arr, copy=True)).to(template.dtype)


def state_from_jax(tree, geo: ApmGeometry) -> ApmState:
    """The JAX package's batch-first ``ApmState`` (vmapped ``init_state``
    or step output, leaves converted to numpy) -> the port's state on the
    CPU, leaf by leaf. Raises if the JAX state holds a component this port
    does not run."""
    template = init_state(geo, batch=1, device="cpu")
    return tree_to_state(template, tree)


def state_to_numpy(state) -> dict:
    """Flatten a state to {dotted path: numpy array}; the paths are the JAX
    pytree's attribute paths."""
    out = {}

    def walk(node, path):
        if node is None:
            return
        if dataclasses.is_dataclass(node):
            for f in dataclasses.fields(node):
                walk(getattr(node, f.name),
                     f"{path}.{f.name}" if path else f.name)
        else:
            out[path] = node.detach().cpu().numpy()

    walk(state, "")
    return out
