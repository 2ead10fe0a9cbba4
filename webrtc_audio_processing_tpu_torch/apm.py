"""AudioProcessing: the top-level APM pipeline, batched over streams.

Port of ``webrtc_audio_processing_tpu/apm.py``, the desktop branch
(reference: audio_processing_impl.cc, ProcessCaptureStreamLocked :1264-1561
and ProcessRenderStreamLocked :1653-1687): AudioBuffer copy-in (resampled
to the processing rate), the full-band HPF, input RMS, band split (one
band, the two-band QMF or the three-band filter bank), the echo
controller's mono narrowing, the split-band HPF, NS analyze, AEC3, NS
process, band merge, the residual echo detector, AGC2 with the internal
RNN-VAD, the 48 kHz PostFilter, output RMS, copy-out (resampled back to the
API rate). The render side feeds the echo detector, AGC1 and AEC3 its
split bands, merges and copies back. API rates 8, 16, 32 and 48 kHz, with 1
or 2 capture and render channels. The capture levels: the pre-amplifier,
the capture levels adjuster's pre and post gains, and AGC2's input volume
controller (``GainController2::Analyze`` on the pre-processed capture).
AGC1 in its three modes: the legacy analysis on the int16 export of the
split bands, the hybrid ``AgcManagerDirect`` on split band 0 (adaptive
analog with the analog controller, the config's default) picking the
digital compression, and the float gain on the bands.

Usage, with B streams on one device::

    geo = ApmGeometry.create(config, 48000, 2, num_render_channels=2)
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
switch for a caller that wants it). The hybrid AGC's analytics VAD runs on
a 30 ms cadence, so with it the step's static cadence has period 6
(``parity_period``): the frame counter gives AEC3 its ``% 2`` and the
manager its ``% 3``. In mobile mode (``EchoCanceller(mobile_mode=True)``)
AECM takes AEC3's place on split band 0 (16 kHz: the capture is never
processed below it), one canceller per (capture, render) channel pair,
after NS; it reads ``stream_delay_ms``, and its 80 -> 64 rebuffering
phase is state, so it adds nothing to the period.

Injected components (``builder.Injections``) run at the reference's
positions: the render pre-processor right after the render copy-in, an
injected echo detector in place of the built-in one, an injected echo
control (``EchoControlFactory.create``) in place of AEC3, the capture
analyzer after the echo detector, the capture post-processor after the
PostFilter and before the output RMS, and the neural residual echo
estimator inside AEC3. Their states are fields of ``ApmState``, batch
first. With ``debug_taps`` the stats carry AEC3's last block's internals
under ``"aec3_taps"``; ``aec3_pair_phase=False`` runs AEC3's per-block
capture path.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from webrtc_audio_processing_tpu_torch import config as cfg_mod
from webrtc_audio_processing_tpu_torch.models import (
    audio_buffer,
    capture_levels_adjuster as cla,
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
    render_buffer as aec3_render_buffer,
)
from webrtc_audio_processing_tpu_torch.models.aecm import (
    echo_control_mobile as ecm,
)
from webrtc_audio_processing_tpu_torch.models.agc1 import (
    agc_manager_direct as amd,
    analog as agc1_analog,
    digital as agc1_digital,
    gain_control as gc1,
)
from webrtc_audio_processing_tpu_torch.models.agc2 import (
    gain_controller2 as gc2,
)
from webrtc_audio_processing_tpu_torch.ops import audio_util
from webrtc_audio_processing_tpu_torch.ops import batch as batch_ops
from webrtc_audio_processing_tpu_torch.ops import gain_ramp

DELAY_HISTORY_FRAMES = 100


def _to_s16(x: torch.Tensor) -> torch.Tensor:
    """The int16 export AGC1 analyses, as int32 (the JAX package's
    ``apm._to_s16``, which rounds then clamps: the same values)."""
    return audio_util.float_s16_to_s16(x).to(torch.int32)


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
    aecm: ecm.AecmGeometry | None = None
    # The injected components (builder.Injections); None when none is.
    injections: object | None = None
    # The injected echo control (EchoControlFactory.create's object), in
    # place of the built-in AEC3 (echo_control.h:51-60).
    echo_control: object | None = None
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
        aec3_pair_phase: bool = True,
    ) -> "ApmGeometry":
        aec3_render_buffer.ring_torch_dtype(aec3_ring_dtype)  # or raise
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

        aec_geo = aecm_geo = echo_control = None
        dynamic_stereo = False
        factory = getattr(injections, "echo_control_factory", None)
        nree = getattr(injections, "neural_residual_echo_estimator", None)
        if config.echo_canceller.enabled and config.echo_canceller.mobile_mode:
            # EchoControlMobileImpl's defaults: the Speakerphone routing,
            # comfort noise off (echo_control_mobile_impl.cc:108-109); it
            # runs on split band 0 only.
            aecm_geo = ecm.AecmGeometry(sample_rate_hz=min(cap_rate, 16000),
                                        echo_mode=3, cng=False)
        elif config.echo_canceller.enabled and factory is not None:
            # InitializeEchoController with an injected factory
            # (audio_processing_impl.cc:1909-1930).
            cap_ch = (num_capture_channels
                      if config.pipeline.multi_channel_capture else 1)
            echo_control = factory.create(cap_rate, ren_channels, cap_ch)
        elif config.echo_canceller.enabled:
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
                cap_ch, nree=nree, debug_taps=debug_taps,
                ring_dtype=aec3_ring_dtype, pair_phase=aec3_pair_phase,
                pair_kernel=aec3_pair_kernel)

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
            aecm=aecm_geo,
            injections=injections,
            echo_control=echo_control,
            aec3_dynamic_stereo=dynamic_stereo,
        )

    @property
    def echo_controller_enabled(self) -> bool:
        """AEC3 or an injected echo control runs (not AECM): the condition
        for mono capture processing (audio_processing_impl.cc:798-806)."""
        return self.aec3 is not None or self.echo_control is not None

    @property
    def capture_processing_channels(self) -> int:
        """Mono capture processing under an echo controller unless
        multichannel capture is on (audio_processing_impl.cc:798-806)."""
        if (self.echo_controller_enabled
                and not self.config.pipeline.multi_channel_capture):
            return 1
        return self.num_capture_channels

    @property
    def agc1_hybrid(self) -> bool:
        """True when AGC1 runs as AgcManagerDirect with fixed-digital
        compression (InitializeGainController1,
        audio_processing_impl.cc:1991-2067)."""
        c = self.config.gain_controller1
        return c.enabled and c.analog_gain_controller.enabled

    @property
    def hpf_enabled(self) -> bool:
        """HighPassFilteringRequired (audio_processing_impl.cc:439-442: the
        HPF, NS or the mobile AECM) or enforced by the desktop echo
        canceller (:1883-1890)."""
        c = self.config
        ec = c.echo_canceller
        return (c.high_pass_filter.enabled or c.noise_suppression.enabled
                or (ec.enabled and ec.mobile_mode)
                or (ec.enabled and ec.enforce_high_pass_filtering
                    and not ec.mobile_mode))

    @property
    def post_filter_enabled(self) -> bool:
        """PostFilter::CreateIfNeeded: only at exactly 48 kHz, only with the
        desktop echo canceller, built in or injected (post_filter.cc:44-52,
        audio_processing_impl.cc:1954-1959)."""
        return (post_filter.is_needed(self.capture_processing_rate)
                and self.echo_controller_enabled)

    @property
    def hpf_full_band(self) -> bool:
        return self.config.high_pass_filter.apply_in_full_band

    @property
    def hpf_rate(self) -> int:
        """The split-band HPF runs on band 0 at 16 kHz; the full-band HPF
        selects coefficients at the 48 kHz output rate when processing runs
        below it (the reference's quirky pairing,
        audio_processing_impl.cc:1282-1287, :1891-1896)."""
        if not self.hpf_full_band:
            return 16000
        if (self.capture_output_rate == 48000
                and self.capture_processing_rate < 48000):
            return 48000
        return self.capture_processing_rate

    @property
    def hpf_channels(self) -> int:
        """The full-band HPF runs before the mono narrowing, on every
        capture channel; the split-band one after it
        (audio_processing_impl.cc:1891-1896)."""
        return (self.num_capture_channels if self.hpf_full_band
                else self.capture_processing_channels)

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


def parity_period(geo: ApmGeometry) -> int:
    """The period of the step's static cadence: AEC3's 2-frame block
    cycle, AECM's (1: its rebuffering phase is state) and with the hybrid
    AGC its analytics VAD's 3-frame one (JAX api.py:322-333)."""
    period = 2
    if geo.aecm is not None:
        period = math.lcm(period, geo.aecm.period)
    if geo.agc1_hybrid:
        period = math.lcm(period, 3)
    return period


@functools.lru_cache(maxsize=8)
def hybrid_gain_tables(target_level_dbfs: int = 2) -> np.ndarray:
    """The (19, 32) gain tables of compression 0..18 dB
    (SetupDigitalGainControl + WebRtcAgc_set_config): the hybrid path
    switches compression at run time, so every table is made once and
    picked by index."""
    return np.stack([agc1_digital.calculate_gain_table(
        c, target_level_dbfs, True, c) for c in range(19)])


def agc1_config(geo: ApmGeometry) -> agc1_analog.LegacyAgcConfig:
    """The legacy AGC's static config (JAX apm.py:314-328)."""
    c = geo.config
    if geo.agc1_hybrid:
        # SetupDigitalGainControl (agc_manager_direct.cc:533-552).
        dda = not c.gain_controller1.analog_gain_controller \
            .enable_digital_adaptive
        return agc1_analog.LegacyAgcConfig(
            agc_mode=agc1_digital.AGC_MODE_FIXED_DIGITAL,
            fs=min(geo.capture_processing_rate, 16000),
            target_level_dbfs=0 if dda else 2,
            compression_gain_db=0 if dda else amd.DEFAULT_COMPRESSION_GAIN,
            limiter_enable=not dda,
        )
    return gc1.make_config(c.gain_controller1,
                           min(geo.capture_processing_rate, 16000))


@dataclass
class ApmState:
    """The JAX ``ApmState`` fields this chain uses, leaves (B, ...); AEC3's
    block ordinal, a 0-d tensor; and the frame counter, a plain int. Both
    are uniform across the batch."""

    capture_buffer: audio_buffer.AudioBufferState
    render_buffer: audio_buffer.AudioBufferState
    pre_amp_gain: torch.Tensor | None  # (B,) the applied gain (ramp start)
    hpf: hpf.HighPassFilterState | None
    cla: cla.CaptureLevelsAdjusterState | None
    ns: ns.NsState | None
    agc1: gc1.GainControlState | None
    agc_mgr: amd.AgcManagerDirectState | None
    aec: ec3.EchoCanceller3State | None
    aecm: ecm.AecmState | None  # leaves (B, C_cap * C_ren, ...)
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
    # The injected components' states (builder.Injections), batch first.
    custom_render_pre: object | None = None
    custom_capture_post: object | None = None
    custom_analyzer: object | None = None
    echo_control: object | None = None
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
            "the port puts the state on the GPU by default and no CUDA "
            "device is available; pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda")


class _BuiltinEchoDetector:
    """models/echo_detector.py with the EchoDetectorInjection surface, its
    functions looked up on the module at each call."""

    @staticmethod
    def init(batch, device):
        return echo_detector.init_state(batch, device)

    @staticmethod
    def analyze_render_audio(state, render):
        return echo_detector.analyze_render_audio(state, render)

    @staticmethod
    def analyze_capture_audio(state, capture):
        return echo_detector.analyze_capture_audio(state, capture)

    @staticmethod
    def get_metrics(state):
        return echo_detector.get_metrics(state)


def ed_module(geo: ApmGeometry):
    """The active echo detector: the injected one (the SetEchoDetector
    seam, audio_processing.h:848-879) or the built-in
    ResidualEchoDetector."""
    inj = getattr(geo.injections, "echo_detector", None)
    return inj if inj is not None else _BuiltinEchoDetector


def _injected(geo: ApmGeometry, name: str):
    return getattr(geo.injections, name, None)


def init_state(geo: ApmGeometry, batch: int, device=None) -> ApmState:
    """The state of B streams, on the card unless ``device`` says
    otherwise."""
    device = _resolve_device(device)
    c = geo.config
    render_pre = _injected(geo, "render_pre_processing")
    capture_post = _injected(geo, "capture_post_processing")
    analyzer = _injected(geo, "capture_analyzer")
    cap_cfg = geo.capture_buffer_config()
    cla_cfg = c.capture_level_adjustment
    proc_ch = geo.capture_processing_channels
    has_aec = geo.aec3 is not None
    return ApmState(
        capture_buffer=audio_buffer.init_state(cap_cfg, batch, device),
        render_buffer=audio_buffer.init_state(geo.render_buffer_config(),
                                              batch, device),
        pre_amp_gain=(torch.full((batch,), c.pre_amplifier.fixed_gain_factor,
                                 dtype=torch.float32, device=device)
                      if c.pre_amplifier.enabled else None),
        hpf=(hpf.init_state(batch, geo.hpf_channels, device)
             if geo.hpf_enabled else None),
        cla=(cla.init_state(
            cla_cfg.pre_gain_factor, cla_cfg.post_gain_factor,
            cla_cfg.analog_mic_gain_emulation.initial_level,
            cla_cfg.analog_mic_gain_emulation.enabled, batch, device)
             if cla_cfg.enabled else None),
        ns=(ns.init_state(batch, proc_ch, cap_cfg.num_bands, device)
            if c.noise_suppression.enabled else None),
        agc1=(gc1.init_state(agc1_config(geo), proc_ch, batch, device)
              if c.gain_controller1.enabled else None),
        agc_mgr=(amd.init_state(
            proc_ch, batch, device,
            c.gain_controller1.analog_gain_controller.clipped_wait_frames)
            if geo.agc1_hybrid else None),
        aec=ec3.init_state(geo.aec3, batch, device) if has_aec else None,
        aecm=(_init_aecm_states(geo, batch, device)
              if geo.aecm is not None else None),
        agc2=(gc2.init_state(c.gain_controller2, geo.capture_processing_rate,
                             batch, device, num_channels=proc_ch)
              if c.gain_controller2.enabled else None),
        pf=(post_filter.init_state(batch, proc_ch, device)
            if geo.post_filter_enabled else None),
        ed=(ed_module(geo).init(batch, device)
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
        custom_render_pre=(
            render_pre.init(geo.render_processing_rate,
                            geo.render_processing_channels, batch, device)
            if render_pre is not None else None),
        custom_capture_post=(
            capture_post.init(geo.capture_processing_rate, proc_ch, batch,
                              device)
            if capture_post is not None else None),
        custom_analyzer=(
            analyzer.init(geo.capture_processing_rate, proc_ch, batch,
                          device)
            if analyzer is not None else None),
        echo_control=(geo.echo_control.init_state(batch, device)
                      if geo.echo_control is not None else None),
        aec3_block_ordinal=(torch.zeros((), dtype=torch.int32, device=device)
                            if has_aec else None),
    )


def _init_aecm_states(geo: ApmGeometry, batch: int, device):
    """One AECM canceller per (capture, render) channel pair, capture
    major (EchoControlMobileImpl::NumCancellersRequired, its handle_index
    layout): leaves (B, C_cap * C_ren, ...)."""
    n = geo.capture_processing_channels * geo.render_processing_channels
    return gc1.unflatten_channels(
        ecm.init_state(geo.aecm, batch * n, device), batch, n)


def _push(history: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """Drop the oldest entry, append ``value`` (B,) as the newest."""
    return torch.cat([history[:, 1:], value.to(history.dtype)[:, None]], 1)


class Apm(nn.Module):
    """The capture and render chain of one geometry; its constants are the
    registered buffers of its submodules."""

    def __init__(self, geo: ApmGeometry, raw_vad_weights: dict | None = None):
        super().__init__()
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
        self.ed = ed_module(geo)
        self.render_pre = _injected(geo, "render_pre_processing")
        self.capture_post = _injected(geo, "capture_post_processing")
        self.capture_analyzer = _injected(geo, "capture_analyzer")
        self.agc1 = None
        self.agc_mgr = None
        if c.gain_controller1.enabled:
            self.agc1 = gc1.GainControl(agc1_config(geo))
        if geo.agc1_hybrid:
            agc = c.gain_controller1.analog_gain_controller
            self.agc_mgr = amd.AgcManagerDirect(
                clipped_level_min=agc.clipped_level_min,
                disable_digital_adaptive=not agc.enable_digital_adaptive)
            self.register_buffer("hybrid_tables", torch.from_numpy(
                hybrid_gain_tables()))

    def process_render_stream(self, state: ApmState, render: torch.Tensor,
                              feed_valid=None):
        """Render half (ProcessRenderStreamLocked, :1653-1687): copy in, the
        echo detector's render analysis, split, merge, copy back.

        ``feed_valid``: None when the frame is real; False, or a (B,) bool
        tensor false on the rows, where the frame is a fabricated silence
        (no queued render, or queued render a re-init dropped). The echo
        detector, the render queue's consumer, is not fed there: the
        reference's EmptyQueuedRenderAudioLocked finds an empty queue.

        Returns (state, render_out, render_bands)."""
        rb = self.render_buffer
        rbuf, r = rb.copy_from(state.render_buffer, render)
        # The injected render pre-processor (:1659-1661), ahead of every
        # render consumer.
        if self.render_pre is not None:
            pre, r = self.render_pre.process(state.custom_render_pre, r)
            state = dataclasses.replace(state, custom_render_pre=pre)
        if state.ed is not None and feed_valid is not False:
            ed = self.ed.analyze_render_audio(state.ed, r)
            if feed_valid is not None and feed_valid is not True:
                ed = batch_ops.tree_where(feed_valid, ed, state.ed)
            state = dataclasses.replace(state, ed=ed)
        if rb.cfg.num_bands > 1:
            rbuf, render_bands = rb.split_into_frequency_bands(rbuf, r)
            rbuf, r = rb.merge_frequency_bands(rbuf, render_bands)
        else:
            render_bands = r[:, None]
        # AGC1's far-end analysis of the packed mono band 0
        # (QueueBandedRenderAudio :1671): each channel rounded to int16,
        # then their integer mean (PackRenderAudioBuffer,
        # gain_control_impl.cc:130-142).
        if state.agc1 is not None and feed_valid is not False:
            ssum = torch.sum(_to_s16(render_bands[:, 0]), -1,
                             dtype=torch.int32)
            far = torch.sign(ssum) * (torch.abs(ssum)
                                      // render_bands.shape[-1])
            agc1 = gc1.process_render_audio(self.agc1.cfg, state.agc1, far)
            if feed_valid is not None and feed_valid is not True:
                agc1 = batch_ops.tree_where(feed_valid, agc1, state.agc1)
            state = dataclasses.replace(state, agc1=agc1)
        # AECM's far-end buffering: canceller (i, j) takes render channel
        # j's band 0 in int16, capture major
        # (EchoControlMobileImpl::PackRenderAudioBuffer, :131-156).
        if state.aecm is not None and feed_valid is not False:
            aecm = buffer_aecm_far_end(state.aecm, render_bands)
            if feed_valid is not None and feed_valid is not True:
                aecm = batch_ops.tree_where(feed_valid, aecm, state.aecm)
            state = dataclasses.replace(state, aecm=aecm)
        rbuf, render_out = rb.copy_to(rbuf, r)
        return (dataclasses.replace(state, render_buffer=rbuf), render_out,
                render_bands)

    def forward(self, state: ApmState, capture: torch.Tensor,
                render: torch.Tensor | None = None, *,
                render_bands: torch.Tensor | None = None,
                render_valid=None, stream_delay_ms=None,
                applied_input_volume=None):
        """One paired 10 ms step: render, then capture.

        capture: (B, capture_in_frames, C_cap), render: (B, render_in_frames,
        C_ren), both in [-1, 1]. ``render_bands``: in place of ``render``,
        the bands an earlier ``process_render_stream`` made (a capture-only
        step). ``render_valid``: see ``process_render_stream``'s
        ``feed_valid``. ``stream_delay_ms``: the reported delay AECM reads
        (an int or (B,) int32, 0 when not given; the desktop path ignores
        it, as the JAX package's does). ``applied_input_volume``: the mic
        volume (an int or (B,) int32) for AGC2's input volume controller
        and the hybrid AGC1, 0 when not given. Returns (state,
        capture_out, render_out, stats), every stats value batch-first.
        """
        geo = self.geo
        c = geo.config
        f = state.frame_counter
        render_out = render
        if render is not None:
            if render_bands is not None:
                raise ValueError("pass render or render_bands, not both")
            state, render_out, render_bands = self.process_render_stream(
                state, render, feed_valid=render_valid)
        elif state.aec is not None and render_bands is None:
            raise ValueError(
                "with the echo canceller on, every step needs a render frame "
                "or its bands (pass silence when the far end sends none)")

        cb = self.capture_buffer
        cbuf, y = cb.copy_from(state.capture_buffer, capture)

        # Full-band HPF (:1282-1287).
        new_hpf = state.hpf
        if self.hpf is not None and geo.hpf_full_band:
            new_hpf, y = self.hpf(state.hpf, y)

        # Pre-amplifier and the capture levels adjuster's pre gain
        # (:1289-1299; the reference routes the pre-amplifier through the
        # adjuster, :972-981).
        pre_amp_gain = state.pre_amp_gain
        if pre_amp_gain is not None:
            g = torch.full_like(pre_amp_gain,
                                c.pre_amplifier.fixed_gain_factor)
            gains = gain_ramp.ramped_gains_scaler(pre_amp_gain, g, y.shape[1])
            y = torch.clamp(y * gains[:, :, None], -32768.0, 32767.0)
            pre_amp_gain = g
        new_cla = state.cla
        if new_cla is not None:
            new_cla, y = cla.apply_pre_level_adjustment(
                new_cla, y,
                c.capture_level_adjustment.analog_mic_gain_emulation.enabled)

        input_rms = rms_level.analyze(state.input_rms, y)

        # AGC2's input volume analysis on the pre-processed capture
        # (GainController2::Analyze, :1317).
        new_agc2 = state.agc2
        if new_agc2 is not None and new_agc2.ivc is not None:
            new_agc2 = gc2.analyze(
                new_agc2,
                0 if applied_input_volume is None else applied_input_volume,
                y)

        # The hybrid AGC's clipping analysis (AnalyzePreProcess,
        # :1345-1346), after the applied volume is set.
        new_mgr = state.agc_mgr
        if new_mgr is not None:
            agc = c.gain_controller1.analog_gain_controller
            new_mgr = amd.set_stream_analog_level(
                new_mgr,
                0 if applied_input_volume is None else applied_input_volume)
            new_mgr = amd.analyze_pre_process(
                new_mgr, y, clipped_level_step=agc.clipped_level_step,
                clipped_ratio_threshold=agc.clipped_ratio_threshold,
                clipped_wait_frames=agc.clipped_wait_frames,
                clipped_level_min=agc.clipped_level_min)

        # Band split (:1359-1363).
        if cb.cfg.num_bands > 1:
            cbuf, bands = cb.split_into_frequency_bands(cbuf, y)
        else:
            bands = y[:, None]

        # Echo-controller mono narrowing (:1365-1373): channel 0 only.
        proc_ch = geo.capture_processing_channels
        if geo.echo_controller_enabled and proc_ch < bands.shape[-1]:
            bands = bands[..., :proc_ch]

        # Split-band HPF (:1375-1380): band 0 with the 16 kHz table.
        if self.hpf is not None and not geo.hpf_full_band:
            new_hpf, b0 = self.hpf(state.hpf, bands[:, 0])
            bands = torch.cat([b0[:, None], bands[:, 1:]], dim=1)

        # AGC1's analysis (:1382-1385) on an int16 export of the bands: it
        # changes AGC1's state only (gain_control_impl.cc:150-195).
        new_agc1 = state.agc1
        if new_agc1 is not None:
            new_agc1, _ = gc1.analyze_capture_audio(
                self.agc1.cfg, new_agc1, _to_s16(bands))

        # NS analyze (pre-AEC, :1387-1391).
        new_ns = state.ns
        if self.ns is not None:
            new_ns = self.ns.analyze(state.ns, bands[:, 0])

        # AEC3 (:1407-1416) at this frame's parity and block ordinal, or
        # the injected echo control (echo_control.h).
        stats = {}
        new_aec = state.aec
        new_echo_control = state.echo_control
        ordinal = state.aec3_block_ordinal
        linear_out = None
        if state.aec is not None:
            parity = f % 2
            aec_out = ec3.process_frame(
                geo.aec3, state.aec, render_bands, bands, parity, ordinal)
            new_aec, bands, linear_out = aec_out[:3]
            if geo.aec3.debug_taps:
                stats["aec3_taps"] = aec_out[3]
            ordinal = ordinal + (3 if parity else 2)
        elif new_echo_control is not None:
            new_echo_control, bands, linear_out = \
                geo.echo_control.process_frame(new_echo_control,
                                               render_bands, bands, f % 2)

        # AECM (mobile mode, :1393-1405 through EchoControlMobileImpl) on
        # band 0: NS.Process runs before it (:1400-1402), the inverse of
        # the desktop order; the cancellers cascade over render channels
        # and the upper bands are zeroed (echo_control_mobile_impl.cc:
        # 165-226).
        new_aecm = state.aecm
        if new_aecm is not None:
            if self.ns is not None:
                new_ns, bands = self.ns.process(new_ns, bands)
            new_aecm, bands = process_aecm(
                geo.aecm, new_aecm, bands,
                0 if stream_delay_ms is None else stream_delay_ms)

        # NS process (:1423-1425), the desktop branch's.
        if self.ns is not None and new_aecm is None:
            new_ns, bands = self.ns.process(new_ns, bands)

        # The hybrid AGC (AgcManagerDirect::Process, :1428-1436) on split
        # band 0 at the analytics VAD's phase; its slewed compression picks
        # this frame's gain table (the reference applies it on the next
        # frame: one 0.05 dB step of skew at most, as in the JAX package).
        table = None
        if new_mgr is not None:
            new_mgr, rec_vol, compression, vp = self.agc_mgr(
                new_mgr, _to_s16(bands[:, 0]), f % 3)
            stats["agc1_recommended_level"] = rec_vol
            stats["agc1_voice_probability"] = vp
            table = self.hybrid_tables[torch.clamp(compression, 0, 18)
                                       .long()]

        # AGC1 process (:1438-1442): Analyze on a fresh int16 export, then
        # the impl's float gain on the float bands.
        if new_agc1 is not None:
            new_agc1, _ = gc1.process_capture_audio(
                self.agc1.cfg, new_agc1, _to_s16(bands), False,
                gain_table=table, return_bands=False)
            bands = gc1.apply_digital_gain_float(
                gc1.shared_gains(new_agc1), bands)
            if new_mgr is None:
                stats["agc1_recommended_level"] = new_agc1.analog_level
            stats["agc1_saturation_warning"] = new_agc1.saturation_warning

        # Merge bands (:1444-1448).
        if cb.cfg.num_bands > 1:
            cbuf, y = cb.merge_frequency_bands(cbuf, bands)
        else:
            y = bands[:, 0]

        # Echo detector capture analysis (:1462-1465).
        new_ed = state.ed
        if state.ed is not None:
            new_ed = self.ed.analyze_capture_audio(state.ed, y)
            stats.update(self.ed.get_metrics(new_ed))

        # The injected capture analyzer (CustomAudioAnalyzer::Analyze,
        # :1468-1470).
        new_analyzer = state.custom_analyzer
        if self.capture_analyzer is not None:
            new_analyzer = self.capture_analyzer.analyze(new_analyzer, y)

        # AGC2 (:1472-1477).
        if self.agc2 is not None:
            new_agc2, y, info = self.agc2(new_agc2, y)
            stats.update({f"agc2_{k}": v for k, v in info.items()})

        # PostFilter (:1479-1481), only at exactly 48 kHz with AEC3.
        new_pf = state.pf
        if self.post_filter is not None:
            new_pf, y = self.post_filter(state.pf, y)

        # The injected capture post-processor (CustomProcessing,
        # :1483-1485).
        new_post = state.custom_capture_post
        if self.capture_post is not None:
            new_post, y = self.capture_post.process(new_post, y)

        output_rms = rms_level.analyze(state.output_rms, y)

        # The capture levels adjuster's post gain (:1526-1538).
        if new_cla is not None:
            new_cla, y = cla.apply_post_level_adjustment(new_cla, y)

        cbuf, out = cb.copy_to(cbuf, y)

        state = dataclasses.replace(
            state,
            capture_buffer=cbuf,
            pre_amp_gain=pre_amp_gain,
            hpf=new_hpf,
            cla=new_cla,
            ns=new_ns,
            agc1=new_agc1,
            agc_mgr=new_mgr,
            aec=new_aec,
            aecm=new_aecm,
            agc2=new_agc2,
            pf=new_pf,
            ed=new_ed,
            custom_capture_post=new_post,
            custom_analyzer=new_analyzer,
            echo_control=new_echo_control,
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
        elif new_echo_control is not None:
            stats.update(geo.echo_control.get_metrics(new_echo_control))
        if linear_out is not None:
            # GetLinearAecOutput (audio_processing.h:584): the 16 kHz
            # linear AEC error of this frame, (B, 160, C).
            stats["linear_aec_output"] = linear_out
        return state, out, render_out, stats


def process_aecm(geo: ecm.AecmGeometry, aecm_state: ecm.AecmState,
                 bands: torch.Tensor, stream_delay_ms):
    """The mobile echo canceller on band 0 of ``bands`` (B, nb, L, C_cap):
    for each render channel j in turn, the cancellers (i, j) on capture
    channel i's band, which the stage before wrote; the upper bands are
    zeroed. ``stream_delay_ms``: an int or (B,) int32. Returns (state,
    bands)."""
    B, nb, L, c_cap = bands.shape
    c_ren = aecm_state.far_written.shape[1] // c_cap
    delay = stream_delay_ms
    if torch.is_tensor(delay):
        delay = delay.to(torch.int32).reshape(-1).expand(B) \
            .repeat_interleave(c_cap)
    x = _to_s16(bands[:, 0]).permute(0, 2, 1).reshape(B * c_cap, L)

    def pick(t, j):  # (B, C_cap * C_ren, ...) -> (B * C_cap, ...)
        return t.reshape((B, c_cap, c_ren) + tuple(t.shape[2:]))[
            :, :, j].reshape((B * c_cap,) + tuple(t.shape[2:]))

    done = []
    for j in range(c_ren):
        st, x = ecm.process_frame(
            geo, gc1._map(lambda t, j=j: pick(t, j), aecm_state), x,
            delay)
        done.append(gc1.unflatten_channels(st, B, c_cap))
    aecm_state = _stack_render_channels(done)
    y = x.reshape(B, c_cap, L).permute(0, 2, 1).to(bands.dtype)
    bands = torch.cat([y[:, None], torch.zeros_like(bands[:, 1:])], 1)
    return aecm_state, bands


def buffer_aecm_far_end(aecm_state: ecm.AecmState,
                        render_bands: torch.Tensor) -> ecm.AecmState:
    """Every canceller (i, j) buffers render channel j's band 0 of
    ``render_bands`` (B, nb, L, C_ren), in int16."""
    B, n = aecm_state.far_written.shape
    far = _to_s16(render_bands[:, 0]).permute(0, 2, 1).repeat(
        1, n // render_bands.shape[-1], 1)
    return gc1.unflatten_channels(ecm.buffer_farend(
        gc1.flatten_channels(aecm_state), far.reshape(B * n, -1)), B, n)


def _stack_render_channels(states: list):
    """[(B, C_cap, ...) per render channel j] -> (B, C_cap * C_ren, ...),
    canceller (i, j) at i * C_ren + j."""
    first = states[0]
    if dataclasses.is_dataclass(first):
        return type(first)(**{
            f.name: _stack_render_channels([getattr(s, f.name)
                                            for s in states])
            for f in dataclasses.fields(first)})
    if len(states) == 1:
        return first
    t = torch.stack(states, 2)  # (B, C_cap, C_ren, ...)
    return t.reshape((t.shape[0], -1) + tuple(t.shape[3:]))


@functools.lru_cache(maxsize=8)
def module_for(geo: ApmGeometry, device: torch.device) -> Apm:
    """The ``Apm`` module of a geometry on a device, built once."""
    return Apm(geo).to(device)


def process_render_stream(geo: ApmGeometry, state: ApmState,
                          render: torch.Tensor, feed_valid=None):
    return module_for(geo, render.device).process_render_stream(
        state, render, feed_valid=feed_valid)


def process_stream_pair(geo: ApmGeometry, state: ApmState,
                        capture: torch.Tensor,
                        render: torch.Tensor | None = None, **kw):
    """One paired step for B streams; see ``Apm.forward`` for the keyword
    arguments."""
    return module_for(geo, capture.device)(state, capture, render, **kw)


# --------------------------------------------------- state from and to JAX


def tree_to_state(template, src, path: str = "state"):
    """Fill the port state ``template`` (for structure, dtypes and trailing
    shapes) from a JAX state pytree with numpy leaves, field by field; an
    injected component's dicts, tuples and lists key by key. A plain-int
    field of the template (the frame counter) and a 0-d tensor (AEC3's
    block ordinal, which the JAX state does not hold) are kept: an injected
    per-stream scalar is a (B,) tensor."""
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
    kids = batch_ops.children(template)
    if kids is not None:
        src_kids = batch_ops.children(src)
        if src_kids is None or [k for k, _ in src_kids] != [k for k, _ in
                                                            kids]:
            raise ValueError(f"{path}: the JAX state's structure differs")
        src_map = dict(src_kids)
        return batch_ops.rebuild(template, {
            k: tree_to_state(v, src_map[k], f"{path}[{k!r}]")
            for k, v in kids})
    if src is None:
        raise ValueError(f"{path}: missing in the JAX state")
    arr = np.asarray(src)
    if arr.shape[1:] != tuple(template.shape[1:]):
        raise ValueError(f"{path}: shape {arr.shape} does not match the "
                         f"port's (B,) + {tuple(template.shape[1:])}")
    if arr.dtype.name == "bfloat16" or template.dtype == torch.bfloat16:
        # numpy has no bf16: JAX hands over ml_dtypes.bfloat16 arrays (or
        # their uint16 bit patterns, as state_to_numpy gives them), which
        # torch.from_numpy refuses; the 16 bits go through int16.
        if arr.dtype.itemsize != 2 or template.dtype != torch.bfloat16:
            raise ValueError(f"{path}: {arr.dtype} leaf for a "
                             f"{template.dtype} one")
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
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
    change in place); the paths are the JAX pytree's key paths
    (``jax.tree_util.keystr`` without its leading dot: ``a.b`` for fields,
    ``a['k']`` for an injected component's dict keys, ``a[0]`` for its
    sequences), and AEC3's block ordinal is the 0-d leaf
    ``aec3_block_ordinal`` (the frame counter is not a leaf). numpy has no
    bfloat16: a bf16 leaf (AEC3's rings with ``aec3_ring_dtype="bfloat16"``)
    is given as its uint16 bit patterns, which ``tree_to_state`` takes
    back."""
    out = {}

    def walk(node, path):
        if node is None or isinstance(node, int):
            return
        if dataclasses.is_dataclass(node):
            for f in dataclasses.fields(node):
                walk(getattr(node, f.name),
                     f"{path}.{f.name}" if path else f.name)
        elif isinstance(node, (dict, tuple, list)):
            for k, v in batch_ops.children(node):
                walk(v, f"{path}[{k!r}]")
        elif node.dtype == torch.bfloat16:
            out[path] = (node.detach().cpu().view(torch.int16).numpy()
                         .view(np.uint16).copy())
        else:
            out[path] = node.detach().cpu().numpy().copy()

    walk(state, "")
    return out
