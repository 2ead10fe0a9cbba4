"""AecDump: record and replay APM sessions in the reference wire format.

Port of ``webrtc_audio_processing_tpu/utils/aec_dump.py`` (reference:
api/audio/aec_dump.h + tests/proto/debug.proto, an Event stream of INIT /
REVERSE_STREAM / STREAM / CONFIG / RUNTIME_SETTING messages, each prefixed
by an int32 LE byte count, tests/test_utils/protobuf_utils.cc, and the
audioproc_f replay tool). The recorder writes numpy frames the API already
holds on the host; ``replay`` runs a dump through the port's
``api.AudioProcessing`` on the device it is given. It reads this format
and the legacy ``.npz`` container of the JAX package's earlier revisions.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from webrtc_audio_processing_tpu_torch.utils import debug_proto as dp

EVENT_INIT = dp.INIT
EVENT_REVERSE_STREAM = dp.REVERSE_STREAM
EVENT_STREAM = dp.STREAM
EVENT_CONFIG = dp.CONFIG
EVENT_RUNTIME_SETTING = dp.RUNTIME_SETTING


class AecDumpRecorder:
    """Writes the debug.proto event stream (WriteInitMessage /
    WriteConfig / Write*StreamMessage / WriteRuntimeSetting)."""

    def __init__(self, path: str):
        self._fh = open(path, "wb")

    def on_init(self, sample_rate: int, num_input_channels: int,
                num_output_channels: int, reverse_sample_rate: int,
                num_reverse_channels: int, output_sample_rate: int):
        dp.write_event(self._fh, dp.init_event(
            sample_rate, num_input_channels, num_output_channels,
            num_reverse_channels, reverse_sample_rate, output_sample_rate,
        ))

    def on_config(self, config) -> None:
        dp.write_event(self._fh, dp.config_event(config))

    def on_reverse_stream(self, render: np.ndarray) -> None:
        dp.write_event(self._fh, dp.reverse_stream_event(render))

    def on_stream(self, capture_in: np.ndarray, capture_out: np.ndarray,
                  delay_ms: int, applied_input_volume: int,
                  keypress: bool = False) -> None:
        dp.write_event(self._fh, dp.stream_event(
            capture_in, capture_out, int(delay_ms),
            int(applied_input_volume), bool(keypress),
        ))

    def on_runtime_setting(self, setting_type: int, value) -> None:
        ev = dp.runtime_setting_event(setting_type, value)
        if ev is not None:
            dp.write_event(self._fh, ev)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def _is_npz(path: str) -> bool:
    with open(path, "rb") as fh:
        return fh.read(2) == b"PK"


def _events_from_npz(path: str):
    """Legacy .npz container (before the wire format) -> event dicts in
    the ``debug_proto.read_dump`` shape. Legacy files numbered
    RUNTIME_SETTING 4 (no UNKNOWN_EVENT slot)."""
    z = np.load(path)
    raw = json.loads(bytes(z["__events__"]).decode())
    out = []
    for ev in raw:
        t = ev["type"]
        if t == 0:
            out.append({"type": dp.INIT, **{k: v for k, v in ev.items()
                                            if k != "type"}})
        elif t == 1:
            arr = np.asarray(z[ev["data"]], np.float32)
            out.append({"type": dp.REVERSE_STREAM,
                        "channels": [arr[:, c] for c in range(arr.shape[1])]})
        elif t == 2:
            inp = np.asarray(z[ev["input"]], np.float32)
            outp = np.asarray(z[ev["output"]], np.float32)
            out.append({
                "type": dp.STREAM,
                "input_channels": [inp[:, c] for c in range(inp.shape[1])],
                "output_channels": [outp[:, c] for c in range(outp.shape[1])],
                "delay": ev.get("delay", 0),
                "applied_input_volume": ev.get("applied_input_volume", 0),
                "keypress": ev.get("keypress", False),
            })
        elif t == 3:
            out.append({"type": dp.CONFIG, "config_json": ev.get("config")})
        else:
            out.append({"type": dp.RUNTIME_SETTING,
                        "setting_type": ev.get("setting_type"),
                        "value": ev.get("value")})
    return out


def load_dump(path: str) -> list[dict]:
    """Event dicts from either a wire-format .aecdump or a legacy .npz."""
    if _is_npz(path):
        return _events_from_npz(path)
    return dp.read_dump(path)


def _stack_channels(channels) -> np.ndarray:
    return np.stack([np.asarray(c, np.float32) for c in channels], axis=-1)


def _config_from_json(cfg_mod, config_json: str):
    """The legacy .npz config snapshot (the whole Config tree as JSON) as
    a ``cfg_mod.Config``; fields it does not name keep their defaults. A
    snapshot that does not parse raises."""
    raw = json.loads(config_json)

    def build(cls, d):
        defaults = cls()
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name not in d:
                continue
            v = d[f.name]
            cur = getattr(defaults, f.name)
            if dataclasses.is_dataclass(cur) and isinstance(v, dict):
                kwargs[f.name] = build(type(cur), v)
            elif hasattr(type(cur), "__members__"):
                kwargs[f.name] = type(cur)(v)
            else:
                kwargs[f.name] = v
        return cls(**kwargs)

    return build(cfg_mod.Config, raw)


def _config_from_event(cfg_mod, ev):
    """A Config from the legacy debug.proto Config fields (the audioproc_f
    mapping)."""
    c = cfg_mod.Config()
    aec = bool(ev.get("aec_enabled", False))
    aecm = bool(ev.get("aecm_enabled", False))
    return c.replace(
        echo_canceller=dataclasses.replace(
            c.echo_canceller, enabled=aec or aecm, mobile_mode=aecm),
        gain_controller1=dataclasses.replace(
            c.gain_controller1,
            enabled=bool(ev.get("agc_enabled", False)),
            mode=cfg_mod.Agc1Mode(dp.AGC_MODES[int(ev.get("agc_mode", 0))]),
            enable_limiter=bool(ev.get("agc_limiter_enabled", True))),
        high_pass_filter=dataclasses.replace(
            c.high_pass_filter, enabled=bool(ev.get("hpf_enabled", False))),
        noise_suppression=dataclasses.replace(
            c.noise_suppression,
            enabled=bool(ev.get("ns_enabled", False)),
            level=cfg_mod.NoiseSuppressionLevel(
                dp.NS_LEVELS[int(ev.get("ns_level", 1))])),
        pre_amplifier=dataclasses.replace(
            c.pre_amplifier,
            enabled=bool(ev.get("pre_amplifier_enabled", False)),
            fixed_gain_factor=float(
                ev.get("pre_amplifier_fixed_gain_factor", 1.0))),
    )


def replay(path: str, config=None, progress=None, device=None):
    """Replay a dump through a fresh ``api.AudioProcessing`` on ``device``
    (the card unless the caller asks for the CPU), as audioproc_f does.

    config: an optional Config in place of the dump's. Returns a list of
    (recorded_output, replayed_output) frame pairs; recorded_output is
    None for dumps that carry no output. ``progress(n)`` is called after
    each replayed capture frame.
    """
    from webrtc_audio_processing_tpu_torch import api as api_mod
    from webrtc_audio_processing_tpu_torch import config as cfg_mod

    RS = api_mod.RuntimeSetting
    names_to_type = {
        "capture_pre_gain": RS.CAPTURE_PRE_GAIN,
        "custom_render_processing_setting": RS.CUSTOM_RENDER_SETTING,
        "capture_fixed_post_gain": RS.CAPTURE_FIXED_POST_GAIN,
        "playout_volume_change": RS.PLAYOUT_VOLUME_CHANGE,
        "capture_output_used": RS.CAPTURE_OUTPUT_USED,
        "capture_post_gain": RS.CAPTURE_POST_GAIN,
    }
    events = load_dump(path)
    ap = None
    sample_rate = 16000
    reverse_rate = None
    num_in = 1
    num_rev = 1
    pairs = []

    def ensure():
        nonlocal ap
        if ap is None:
            ap = api_mod.AudioProcessing(config or cfg_mod.Config(),
                                         device=device)

    for ev in events:
        t = ev["type"]
        if t == dp.INIT:
            sample_rate = ev.get("sample_rate", sample_rate)
            reverse_rate = ev.get("reverse_sample_rate", sample_rate)
            num_in = ev.get("num_input_channels", num_in)
            num_rev = ev.get("num_reverse_channels", num_rev)
        elif t == dp.CONFIG and ap is None and config is None:
            if "config_json" in ev:  # the legacy npz snapshot
                config = _config_from_json(cfg_mod, ev["config_json"])
            else:
                config = _config_from_event(cfg_mod, ev)
        elif t == dp.REVERSE_STREAM:
            ensure()
            if ev.get("channels"):
                ren = _stack_channels(ev["channels"])
            else:
                data = ev["data_int16"].astype(np.float32) / 32768.0
                ren = data.reshape(-1, num_rev)
            ap.process_reverse_stream(ren, reverse_rate or sample_rate)
        elif t == dp.STREAM:
            ensure()
            ap.set_stream_delay_ms(int(ev.get("delay", 0)))
            ap.set_stream_analog_level(int(ev.get("applied_input_volume", 0)))
            ap.set_stream_key_pressed(bool(ev.get("keypress", False)))
            if ev.get("input_channels"):
                cap = _stack_channels(ev["input_channels"])
            else:
                cap = (ev["input_int16"].astype(np.float32)
                       / 32768.0).reshape(-1, num_in)
            _, out = ap.process_stream(cap, sample_rate)
            if ev.get("output_channels"):
                rec = _stack_channels(ev["output_channels"])
            elif "output_int16" in ev:
                rec = (ev["output_int16"].astype(np.float32)
                       / 32768.0).reshape(-1, num_in)
            else:
                rec = None
            pairs.append((rec, np.asarray(out)))
            if progress:
                progress(len(pairs))
        elif t == dp.RUNTIME_SETTING:
            ensure()
            if "setting_type" in ev:  # the legacy npz shape
                ap.set_runtime_setting(RS(int(ev["setting_type"]),
                                          ev.get("value", 0.0)))
            else:
                for name, st in names_to_type.items():
                    if name in ev:
                        ap.set_runtime_setting(RS(st, ev[name]))
    return pairs
