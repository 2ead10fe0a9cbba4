"""GainControlImpl: the APM-facing AGC1 front.

Port of ``webrtc_audio_processing_tpu/models/agc1/gain_control.py``
(reference: modules/audio_processing/gain_control_impl.{h,cc}): one legacy
WebRtcAgc per capture channel; the render side's AddFarend from the packed
mono render, the capture side's analysis (AddMic in adaptive analog,
VirtualMic in adaptive digital), Analyze (digital gains and the analog
loop) and the float gain application, with the analog level arbitration
over channels.

The state mirrors the JAX package's batched pytree: the per-channel AGCs
have (B, C, ...) leaves; the functions run them as B * C rows.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch
from torch import nn

from webrtc_audio_processing_tpu_torch.config import Agc1Mode, GainController1
from webrtc_audio_processing_tpu_torch.models.agc1 import analog, digital

I32 = torch.int32


def mode_to_legacy(mode: Agc1Mode) -> int:
    return {
        Agc1Mode.ADAPTIVE_ANALOG: digital.AGC_MODE_ADAPTIVE_ANALOG,
        Agc1Mode.ADAPTIVE_DIGITAL: digital.AGC_MODE_ADAPTIVE_DIGITAL,
        Agc1Mode.FIXED_DIGITAL: digital.AGC_MODE_FIXED_DIGITAL,
    }[mode]


def make_config(config: GainController1,
                fs_band: int) -> analog.LegacyAgcConfig:
    """BuiltinAgc set-up (gain_control_impl.cc Initialize + set_config)."""
    return analog.LegacyAgcConfig(
        min_level=0,
        max_level=255,
        agc_mode=mode_to_legacy(config.mode),
        fs=fs_band,
        target_level_dbfs=config.target_level_dbfs,
        compression_gain_db=config.compression_gain_db,
        limiter_enable=config.enable_limiter,
    )


@dataclass
class GainControlState:
    agcs: analog.AnalogAgcState  # leaves (B, C, ...)
    gains: torch.Tensor  # (B, C, 11) int32, from Analyze, used by Process
    analog_level: torch.Tensor  # (B,) int32, the shared recommended level
    capture_levels: torch.Tensor  # (B, C) int32 per-channel level loop
    saturation_warning: torch.Tensor  # (B,) bool

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def _map(fn, node):
    if dataclasses.is_dataclass(node):
        return type(node)(**{f.name: _map(fn, getattr(node, f.name))
                             for f in dataclasses.fields(node)})
    return fn(node)


def flatten_channels(tree):
    """(B, C, ...) leaves -> (B * C, ...)."""
    return _map(lambda t: t.reshape((-1,) + tuple(t.shape[2:])), tree)


def unflatten_channels(tree, B: int, C: int):
    """(B * C, ...) leaves -> (B, C, ...)."""
    return _map(lambda t: t.reshape((B, C) + tuple(t.shape[1:])), tree)


def init_state(cfg: analog.LegacyAgcConfig, num_channels: int, batch: int,
               device, initial_level: int = 128) -> GainControlState:
    agcs = unflatten_channels(
        analog.init_state(cfg, batch * num_channels, device), batch,
        num_channels)
    return GainControlState(
        agcs=agcs,
        gains=torch.zeros((batch, num_channels, 11), dtype=I32,
                          device=device),
        analog_level=torch.full((batch,), initial_level, dtype=I32,
                                device=device),
        capture_levels=torch.full((batch, num_channels), initial_level,
                                  dtype=I32, device=device),
        saturation_warning=torch.zeros(batch, dtype=torch.bool,
                                       device=device),
    )


def _rows(bands: torch.Tensor) -> torch.Tensor:
    """(B, num_bands, L, C) -> (B * C, num_bands, L)."""
    B, nb, L, C = bands.shape
    return bands.permute(0, 3, 1, 2).reshape(B * C, nb, L)


def _unrows(x: torch.Tensor, B: int, C: int) -> torch.Tensor:
    nb, L = x.shape[1:]
    return x.reshape(B, C, nb, L).permute(0, 2, 3, 1)


def process_render_audio(cfg: analog.LegacyAgcConfig,
                         state: GainControlState, render_band0):
    """ProcessRenderAudio (gain_control_impl.cc): AddFarend on every
    channel's AGC. render_band0: (B, L) int32, the packed mono render."""
    B, C = state.capture_levels.shape
    agcs = analog.add_far_end(flatten_channels(state.agcs),
                              render_band0.repeat_interleave(C, 0))
    return state.replace(agcs=unflatten_channels(agcs, B, C))


def analyze_capture_audio(cfg: analog.LegacyAgcConfig,
                          state: GainControlState, bands):
    """AnalyzeCaptureAudio (gain_control_impl.cc:148-195): AddMic in
    adaptive analog, VirtualMic in adaptive digital, nothing in fixed
    digital mode.

    bands: (B, num_bands, L, C) int32. Returns (state, bands as the
    analysis modified them)."""
    B, C = state.capture_levels.shape
    x = _rows(bands)
    agcs = flatten_channels(state.agcs)
    if cfg.agc_mode == digital.AGC_MODE_ADAPTIVE_ANALOG:
        # capture_levels_[ch] = analog_capture_level_ (:163).
        agcs, x = analog.add_mic(cfg, agcs, x)
        levels = state.analog_level[:, None].expand(B, C).clone()
    elif cfg.agc_mode == digital.AGC_MODE_ADAPTIVE_DIGITAL:
        agcs, x, levels = analog.virtual_mic(
            cfg, agcs, x, state.analog_level.repeat_interleave(C, 0))
        levels = levels.reshape(B, C)
    else:  # fixed digital: no analysis stage
        return state, bands
    return (state.replace(agcs=unflatten_channels(agcs, B, C),
                          capture_levels=levels),
            _unrows(x, B, C))


def _pick(gains_all: torch.Tensor) -> torch.Tensor:
    """The gain trajectory of the channel with the largest end gain
    (gain_control_impl.cc:228-243): (B, C, 11) -> (B, 11)."""
    idx = torch.argmax(gains_all[:, :, 10], dim=1)
    return torch.gather(gains_all, 1, idx[:, None, None].expand(
        -1, 1, gains_all.shape[2]))[:, 0]


def process_capture_audio(cfg: analog.LegacyAgcConfig,
                          state: GainControlState, bands, stream_has_echo,
                          gain_table=None, return_bands: bool = True):
    """ProcessCaptureAudio: Analyze (gains and the analog loop), then
    Process with the shared gains.

    bands: (B, num_bands, L, C) int32; stream_has_echo: a (B,) tensor or
    a Python scalar;
    gain_table: None, a (32,) table or a per-stream (B, 32) table (the
    hybrid path). Returns (state, out bands, or None when
    ``return_bands`` is false: the APM uses only the analysis)."""
    B, C = state.capture_levels.shape
    x = _rows(bands)
    echo = stream_has_echo
    if torch.is_tensor(echo) and echo.dim() == 1:
        echo = echo.repeat_interleave(C, 0)
    if gain_table is not None and gain_table.dim() == 2:
        gain_table = gain_table.repeat_interleave(C, 0)
    agcs, gains_all, levels, warns = analog.analyze(
        cfg, flatten_channels(state.agcs), x, state.capture_levels.reshape(-1),
        echo, gain_table=gain_table)
    gains_all = gains_all.reshape(B, C, 11)
    levels = levels.reshape(B, C)
    y = None
    if return_bands:
        shared = _pick(gains_all).repeat_interleave(C, 0)
        y = _unrows(analog.process(shared, x), B, C)
    # Analog mode: the lowest recommended level wins
    # (gain_control_impl.cc:246-252); the digital modes keep the user's.
    if cfg.agc_mode == digital.AGC_MODE_ADAPTIVE_ANALOG:
        new_level = torch.amin(levels, 1)
    else:
        new_level = state.analog_level
    return (
        state.replace(
            agcs=unflatten_channels(agcs, B, C),
            gains=gains_all,
            analog_level=new_level,
            capture_levels=levels,
            saturation_warning=warns.reshape(B, C).any(1),
        ),
        y,
    )


def set_stream_analog_level(state: GainControlState, level):
    """``level``: an int or a (B,) tensor."""
    if torch.is_tensor(level):
        lvl = level.to(I32).expand_as(state.analog_level).clone()
    else:
        lvl = torch.full_like(state.analog_level, int(level))
    return state.replace(
        analog_level=lvl,
        capture_levels=lvl[:, None].expand_as(state.capture_levels).clone())


def shared_gains(state: GainControlState) -> torch.Tensor:
    """The frame's gain trajectory applied to every channel, (B, 11)."""
    return _pick(state.gains)


def apply_digital_gain_float(gains: torch.Tensor, bands: torch.Tensor):
    """GainControlImpl's float ApplyDigitalGain (gain_control_impl.cc:
    50-77): the Q16 gains interpolated over 16-sample subsections and
    applied to the float split bands with clamping (the impl never calls
    WebRtcAgc_Process).

    gains: (B, 11) int32; bands: (B, num_bands, 160, C) float."""
    sub = bands.shape[2] // 10
    g = gains.to(torch.float32) * (1.0 / 65536.0)
    delta = (g[:, 1:] - g[:, :10]) * (1.0 / 16.0)
    steps = torch.arange(sub, dtype=torch.float32, device=bands.device)
    per_sample = (g[:, :10, None] + delta[:, :, None] * steps).reshape(
        gains.shape[0], 1, -1, 1)
    return torch.clamp(bands * per_sample, -32768.0, 32767.0)


class GainControl(nn.Module):
    """AGC1's legacy front for one configuration; its gain table is a
    registered buffer."""

    def __init__(self, cfg: analog.LegacyAgcConfig):
        super().__init__()
        self.cfg = cfg
        self.register_buffer("gain_table", torch.from_numpy(
            cfg.gain_table.astype("int32")))

    def forward(self, state: GainControlState, bands, stream_has_echo=0,
                gain_table=None):
        """The analysis, then Analyze and Process, on (B, num_bands, L, C)
        int32 bands, as the APM runs them: the analysis reads its own copy
        of the bands. Returns (state, out bands)."""
        state, _ = analyze_capture_audio(self.cfg, state, bands)
        return process_capture_audio(
            self.cfg, state, bands, stream_has_echo,
            gain_table=self.gain_table if gain_table is None else gain_table)
