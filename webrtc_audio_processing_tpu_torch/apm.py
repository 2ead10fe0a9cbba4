"""AudioProcessing: the top-level APM pipeline, batched over streams.

Port of ``webrtc_audio_processing_tpu/apm.py``, the desktop branch
(reference: audio_processing_impl.cc, ProcessCaptureStreamLocked :1264-1561
and ProcessRenderStreamLocked :1653-1687): AudioBuffer copy-in, full-band
HPF, input RMS, band split, the echo controller's mono narrowing, NS
analyze, AEC3, NS process, band merge, the residual echo detector, AGC2
with the internal RNN-VAD, the 48 kHz PostFilter, output RMS, copy-out.
The render side feeds the echo detector and AEC3 its split bands, merges
and copies back.

Usage, with B streams on one device::

    geo = ApmGeometry.create(config, 48000, 2, num_render_channels=2,
                             aec3_stereo_content=True)
    state = init_state(geo, batch=B)   # on the card; device="cpu" to test
    state, out, render_out, stats = process_stream_pair(
        geo, state, capture, render)   # capture, render: (B, 480, C)

``Apm(geo)`` is the ``nn.Module`` behind ``process_stream_pair``; the
functions keep one per geometry and device. AEC3 runs its blocks on a
static cadence: the state carries a plain frame counter, uniform across the
batch, from which each step takes its parity (the frame's block count, a
static shape), and AEC3's block ordinal as a 0-d int32 tensor on the device
(the JAX package's unbatched ``n0``), from which the ring positions follow,
so that a captured CUDA graph of the step (``step_graph.PairGraph``)
replays correctly; the AEC3 render rings are updated in place. AEC3's
subtractor runs as plain PyTorch unless ``aec3_pair_kernel`` is true, when
it runs on the pair kernel K6
(``ec3.pair_kernel_from_env`` reads the JAX package's ``AEC3_PAIR_KERNEL``
switch for a caller that wants it). Everything outside this chain raises
``NotImplementedError`` naming its ROADMAP item.
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
    echo_detector,
    high_pass_filter as hpf,
    noise_suppressor as ns,
    post_filter,
    rms_level,
)
from webrtc_audio_processing_tpu_torch.models.aec3 import (
    config as aec3_config,
    echo_canceller3 as ec3,
    multi_channel_content_detector as mccd,
)
from webrtc_audio_processing_tpu_torch.models.agc2 import (
    gain_controller2 as gc2,
)

DELAY_HISTORY_FRAMES = 100


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
    aec3: ec3.Aec3Geometry | None = None
    # True when AEC3 runs with stereo render content detection: the host
    # re-creates the geometry when the detector flips (config_selector.cc).
    aec3_dynamic_stereo: bool = False

    @staticmethod
    def create(
        config: cfg_mod.Config,
        capture_input_rate: int,
        num_capture_channels: int = 1,
        capture_output_rate: int | None = None,
        render_input_rate: int | None = None,
        num_render_channels: int = 1,
        render_output_rate: int | None = None,
        aec3_cfg: aec3_config.EchoCanceller3Config | None = None,
        injections: object | None = None,
        debug_taps: bool = False,
        aec3_stereo_content: bool = False,
        aec3_ring_dtype: str = "float32",
        aec3_pair_kernel: bool = False,
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
        if config.echo_canceller.enabled:
            ren_rate = cap_rate
        else:
            ren_rate = suitable_process_rate(
                min(render_input_rate, render_output_rate), max_split,
                multiband)
        ren_channels = (num_render_channels
                        if config.pipeline.multi_channel_render else 1)

        aec_geo = None
        dynamic_stereo = False
        if config.echo_canceller.enabled:
            cap_ch = (num_capture_channels
                      if config.pipeline.multi_channel_capture else 1)
            # Mono/multichannel config selection (audio_processing_impl.cc:
            # 1928-1944, config_selector.cc): the default multichannel
            # config exists only when the caller set no config, and applies
            # once the render side carries stereo content.
            mono_cfg = aec3_cfg or aec3_config.EchoCanceller3Config()
            mc_cfg = (None if aec3_cfg is not None
                      else aec3_config.create_default_multichannel_config())
            detect = mono_cfg.multi_channel.detect_stereo_content
            stereo_proc = ren_channels > 1 and (
                (not detect) or aec3_stereo_content)
            dynamic_stereo = ren_channels > 1 and detect
            active_cfg = mccd.select_config(mono_cfg, mc_cfg, stereo_proc)
            active_cfg, _valid = aec3_config.validate(active_cfg)
            aec_geo = ec3.Aec3Geometry.create(
                active_cfg, cap_rate, ren_channels if stereo_proc else 1,
                cap_ch, debug_taps=debug_taps, ring_dtype=aec3_ring_dtype,
                pair_kernel=aec3_pair_kernel)
        elif debug_taps:
            raise NotImplementedError(
                f"AEC3 debug taps {ec3._ITEM_11}")

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
            aec3=aec_geo,
            aec3_dynamic_stereo=dynamic_stereo,
        )

    @property
    def echo_controller_enabled(self) -> bool:
        return self.aec3 is not None

    @property
    def capture_processing_channels(self) -> int:
        """Mono capture processing under an echo controller unless
        multichannel capture is on (audio_processing_impl.cc:798-806)."""
        if (self.echo_controller_enabled
                and not self.config.pipeline.multi_channel_capture):
            return 1
        return self.num_capture_channels

    @property
    def hpf_enabled(self) -> bool:
        """HighPassFilteringRequired (audio_processing_impl.cc:439-442) or
        enforced by the desktop echo canceller (:1883-1890)."""
        c = self.config
        ec = c.echo_canceller
        return (c.high_pass_filter.enabled or c.noise_suppression.enabled
                or (ec.enabled and ec.enforce_high_pass_filtering
                    and not ec.mobile_mode))

    @property
    def post_filter_enabled(self) -> bool:
        """PostFilter::CreateIfNeeded: only at exactly 48 kHz, only with the
        desktop echo canceller (post_filter.cc:44-52,
        audio_processing_impl.cc:1954-1959)."""
        return (post_filter.is_needed(self.capture_processing_rate)
                and self.aec3 is not None)

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
    """The JAX ``ApmState`` fields this chain uses, leaves (B, ...); AEC3's
    block ordinal, a 0-d tensor; and the frame counter, a plain int. Both
    are uniform across the batch."""

    capture_buffer: audio_buffer.AudioBufferState
    render_buffer: audio_buffer.AudioBufferState
    hpf: hpf.HighPassFilterState | None
    ns: ns.NsState | None
    aec: ec3.EchoCanceller3State | None
    agc2: gc2.Agc2State | None
    pf: post_filter.PostFilterState | None
    ed: echo_detector.EchoDetectorState | None
    input_rms: rms_level.RmsLevelState
    output_rms: rms_level.RmsLevelState
    frame_parity: torch.Tensor  # (B,) int32, informational
    was_stream_delay_set: torch.Tensor  # (B,) bool
    # The last second of AEC3 delay estimates, newest last (stats only).
    delay_history_ms: torch.Tensor | None = None  # (B, 100) int32
    delay_history_valid: torch.Tensor | None = None  # (B, 100) bool
    # AEC3 blocks inserted so far, () int32 on the state's device: the
    # ordinal ``n0`` the JAX package passes to each step (2 blocks in an
    # even frame, 3 in an odd one). Not a leaf of the JAX state.
    aec3_block_ordinal: torch.Tensor | None = None
    # Frames processed since init_state: the parity of AEC3's cadence.
    frame_counter: int = 0


def _resolve_device(device):
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "init_state puts the state on the GPU by default and no CUDA "
            "device is available; pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda")


def init_state(geo: ApmGeometry, batch: int, device=None) -> ApmState:
    """The state of B streams, on the card unless ``device`` says
    otherwise."""
    device = _resolve_device(device)
    c = geo.config
    cap_cfg = geo.capture_buffer_config()
    proc_ch = geo.capture_processing_channels
    has_aec = geo.aec3 is not None
    return ApmState(
        capture_buffer=audio_buffer.init_state(cap_cfg, batch, device),
        render_buffer=audio_buffer.init_state(geo.render_buffer_config(),
                                              batch, device),
        hpf=(hpf.init_state(batch, geo.num_capture_channels, device)
             if geo.hpf_enabled else None),
        ns=(ns.init_state(batch, proc_ch, cap_cfg.num_bands, device)
            if c.noise_suppression.enabled else None),
        aec=ec3.init_state(geo.aec3, batch, device) if has_aec else None,
        agc2=(gc2.init_state(c.gain_controller2, geo.capture_processing_rate,
                             batch, device)
              if c.gain_controller2.enabled else None),
        pf=(post_filter.init_state(batch, proc_ch, device)
            if geo.post_filter_enabled else None),
        ed=(echo_detector.init_state(batch, device)
            if c.echo_canceller.enabled else None),
        input_rms=rms_level.init_state(batch, device),
        output_rms=rms_level.init_state(batch, device),
        frame_parity=torch.zeros(batch, dtype=torch.int32, device=device),
        was_stream_delay_set=torch.zeros(batch, dtype=torch.bool,
                                         device=device),
        delay_history_ms=(torch.zeros((batch, DELAY_HISTORY_FRAMES),
                                      dtype=torch.int32, device=device)
                          if has_aec else None),
        delay_history_valid=(torch.zeros((batch, DELAY_HISTORY_FRAMES),
                                         dtype=torch.bool, device=device)
                             if has_aec else None),
        aec3_block_ordinal=(torch.zeros((), dtype=torch.int32, device=device)
                            if has_aec else None),
    )


def _push(history: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """Drop the oldest entry, append ``value`` (B,) as the newest."""
    return torch.cat([history[:, 1:], value.to(history.dtype)[:, None]], 1)


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
        self.post_filter = (post_filter.PostFilter()
                            if geo.post_filter_enabled else None)

    def process_render_stream(self, state: ApmState, render: torch.Tensor):
        """Render half (ProcessRenderStreamLocked, :1653-1687): copy in, the
        echo detector's render analysis, split, merge, copy back.

        Returns (state, render_out, render_bands)."""
        rb = self.render_buffer
        rbuf, r = rb.copy_from(state.render_buffer, render)
        if state.ed is not None:
            state = dataclasses.replace(
                state, ed=echo_detector.analyze_render_audio(state.ed, r))
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
        stats), every stats value batch-first.
        """
        geo = self.geo
        f = state.frame_counter
        render_out = render
        render_bands = None
        if render is not None:
            state, render_out, render_bands = self.process_render_stream(
                state, render)
        elif state.aec is not None:
            raise ValueError(
                "with the echo canceller on, every step needs a render frame "
                "(pass silence when the far end sends none)")

        cb = self.capture_buffer
        cbuf, y = cb.copy_from(state.capture_buffer, capture)

        # Full-band HPF (:1282-1287).
        new_hpf = state.hpf
        if self.hpf is not None:
            new_hpf, y = self.hpf(state.hpf, y)

        input_rms = rms_level.analyze(state.input_rms, y)

        # Band split (:1359-1363).
        if cb.cfg.num_bands > 1:
            cbuf, bands = cb.split_into_frequency_bands(cbuf, y)
        else:
            bands = y[:, None]

        # Echo-controller mono narrowing (:1365-1373): channel 0 only.
        proc_ch = geo.capture_processing_channels
        if geo.echo_controller_enabled and proc_ch < bands.shape[-1]:
            bands = bands[..., :proc_ch]

        # NS analyze (pre-AEC, :1387-1391).
        new_ns = state.ns
        if self.ns is not None:
            new_ns = self.ns.analyze(state.ns, bands[:, 0])

        # AEC3 (:1407-1416) at this frame's parity and block ordinal.
        stats = {}
        new_aec = state.aec
        ordinal = state.aec3_block_ordinal
        linear_out = None
        if state.aec is not None:
            parity = f % 2
            new_aec, bands, linear_out = ec3.process_frame(
                geo.aec3, state.aec, render_bands, bands, parity, ordinal)
            ordinal = ordinal + (3 if parity else 2)

        # NS process (:1423-1425).
        if self.ns is not None:
            new_ns, bands = self.ns.process(new_ns, bands)

        # Merge bands (:1444-1448).
        if cb.cfg.num_bands > 1:
            cbuf, y = cb.merge_frequency_bands(cbuf, bands)
        else:
            y = bands[:, 0]

        # Echo detector capture analysis (:1462-1465).
        new_ed = state.ed
        if state.ed is not None:
            new_ed = echo_detector.analyze_capture_audio(state.ed, y)
            stats.update(echo_detector.get_metrics(new_ed))

        # AGC2 (:1472-1477).
        new_agc2 = state.agc2
        if self.agc2 is not None:
            new_agc2, y, info = self.agc2(state.agc2, y)
            stats.update({f"agc2_{k}": v for k, v in info.items()})

        # PostFilter (:1479-1481), only at exactly 48 kHz with AEC3.
        new_pf = state.pf
        if self.post_filter is not None:
            new_pf, y = self.post_filter(state.pf, y)

        output_rms = rms_level.analyze(state.output_rms, y)
        cbuf, out = cb.copy_to(cbuf, y)

        state = dataclasses.replace(
            state,
            capture_buffer=cbuf,
            hpf=new_hpf,
            ns=new_ns,
            aec=new_aec,
            agc2=new_agc2,
            pf=new_pf,
            ed=new_ed,
            input_rms=input_rms,
            output_rms=output_rms,
            frame_parity=torch.remainder(state.frame_parity + 1, 2).to(
                torch.int32),
            aec3_block_ordinal=ordinal,
            frame_counter=f + 1,
        )
        if new_aec is not None:
            stats.update(ec3.get_metrics(geo.aec3, new_aec))
            state = dataclasses.replace(
                state,
                delay_history_ms=_push(state.delay_history_ms,
                                       stats["delay_ms"]),
                delay_history_valid=_push(
                    state.delay_history_valid,
                    stats["aec3_external_delay_valid"]),
            )
            # GetLinearAecOutput (audio_processing.h:584): the 16 kHz
            # linear AEC error of this frame, (B, 160, C).
            stats["linear_aec_output"] = linear_out
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
    shapes) from a JAX state pytree with numpy leaves, field by field. A
    plain-int field of the template (the frame counter) and a 0-d tensor
    (AEC3's block ordinal, which the JAX state does not hold) are kept."""
    if template is None:
        if src is not None:
            raise ValueError(f"{path}: the port has no state here")
        return None
    if isinstance(template, int) or (isinstance(template, torch.Tensor)
                                     and template.dim() == 0):
        return template
    if dataclasses.is_dataclass(template):
        out = {}
        for f in dataclasses.fields(template):
            out[f.name] = tree_to_state(getattr(template, f.name),
                                        getattr(src, f.name, None),
                                        f"{path}.{f.name}")
        if dataclasses.is_dataclass(src):
            extra = [f.name for f in dataclasses.fields(src)
                     if f.name not in out and getattr(src, f.name) is not None]
            if extra:
                raise ValueError(f"{path}: state the port does not run: "
                                 f"{extra}")
        return type(template)(**out)
    if src is None:
        raise ValueError(f"{path}: missing in the JAX state")
    arr = np.asarray(src)
    if arr.shape[1:] != tuple(template.shape[1:]):
        raise ValueError(f"{path}: shape {arr.shape} does not match the "
                         f"port's (B,) + {tuple(template.shape[1:])}")
    return torch.from_numpy(np.array(arr, copy=True)).to(template.dtype)


def block_ordinal(frame_counter: int) -> int:
    """AEC3 blocks inserted in the first ``frame_counter`` frames: 5 a
    frame pair, 2 in its even frame (bench.py:94-105)."""
    return 5 * (frame_counter // 2) + 2 * (frame_counter % 2)


def state_from_jax(tree, geo: ApmGeometry, frame_counter: int = 0) -> ApmState:
    """The JAX package's batch-first ``ApmState`` (vmapped ``init_state``
    or step output, leaves converted to numpy) -> the port's state on the
    CPU, leaf by leaf, after ``frame_counter`` frames (which also give
    AEC3's block ordinal). Raises if the JAX state holds a component this
    port does not run."""
    template = init_state(geo, batch=1, device="cpu")
    state = tree_to_state(template, tree)
    ordinal = state.aec3_block_ordinal
    if ordinal is not None:
        ordinal = torch.tensor(block_ordinal(frame_counter),
                               dtype=torch.int32)
    return dataclasses.replace(state, frame_counter=frame_counter,
                               aec3_block_ordinal=ordinal)


def state_to_numpy(state) -> dict:
    """Flatten a state to {dotted path: numpy array}, copies (the AEC3 rings
    change in place); the paths are the JAX pytree's attribute paths, and
    AEC3's block ordinal is the 0-d leaf ``aec3_block_ordinal`` (the frame
    counter is not a leaf)."""
    out = {}

    def walk(node, path):
        if node is None or isinstance(node, int):
            return
        if dataclasses.is_dataclass(node):
            for f in dataclasses.fields(node):
                walk(getattr(node, f.name),
                     f"{path}.{f.name}" if path else f.name)
        else:
            out[path] = node.detach().cpu().numpy().copy()

    walk(state, "")
    return out
