"""debug.proto wire-format codec for AecDump files.

The port's own copy of ``webrtc_audio_processing_tpu/utils/debug_proto.py``
(pure Python and numpy; nothing of it is shared with the JAX package).

Reference: tests/proto/debug.proto (proto2 Event stream: INIT /
REVERSE_STREAM / STREAM / CONFIG / RUNTIME_SETTING) with the framing of
tests/test_utils/protobuf_utils.cc (each serialized Event prefixed by an
int32 little-endian byte count). Hand-rolled encoder/decoder — no protoc
dependency — interoperable with dumps written or read by the reference
(`AttachAecDump`, audioproc_f, `ApmTest.VerifyDebugDump*`).
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

# Event.Type (debug.proto).
INIT = 0
REVERSE_STREAM = 1
STREAM = 2
CONFIG = 3
UNKNOWN_EVENT = 4
RUNTIME_SETTING = 5


# ------------------------------------------------------------- encoding

def _varint(x: int) -> bytes:
    out = bytearray()
    x &= (1 << 64) - 1
    while True:
        b = x & 0x7F
        x >>= 7
        if x:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def enc_int(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(int(v))


def enc_sint(field: int, v: int) -> bytes:
    v = int(v)
    return _tag(field, 0) + _varint((v << 1) ^ (v >> 31))


def enc_bool(field: int, v: bool) -> bytes:
    return enc_int(field, 1 if v else 0)


def enc_float(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", float(v))


def enc_bytes(field: int, v: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(v)) + v


def enc_str(field: int, v: str) -> bytes:
    return enc_bytes(field, v.encode())


def init_event(sample_rate: int, num_input_channels: int,
               num_output_channels: int, num_reverse_channels: int,
               reverse_sample_rate: int, output_sample_rate: int,
               timestamp_ms: int = 0) -> bytes:
    m = (enc_int(1, sample_rate)
         + enc_int(3, num_input_channels)
         + enc_int(4, num_output_channels)
         + enc_int(5, num_reverse_channels)
         + enc_int(6, reverse_sample_rate)
         + enc_int(7, output_sample_rate)
         + enc_int(10, timestamp_ms))
    return enc_int(1, INIT) + enc_bytes(2, m)


def reverse_stream_event(render: np.ndarray) -> bytes:
    """render: (frames, channels) float — stored as deinterleaved float
    channel buffers (debug.proto ReverseStream.channel)."""
    render = np.asarray(render, np.float32)
    m = b"".join(
        enc_bytes(2, np.ascontiguousarray(render[:, ch]).tobytes())
        for ch in range(render.shape[1])
    )
    return enc_int(1, REVERSE_STREAM) + enc_bytes(3, m)


def stream_event(capture_in: np.ndarray, capture_out: np.ndarray,
                 delay_ms: int, applied_input_volume: int,
                 keypress: bool) -> bytes:
    capture_in = np.asarray(capture_in, np.float32)
    capture_out = np.asarray(capture_out, np.float32)
    m = (enc_int(3, delay_ms)
         + enc_sint(4, 0)  # drift
         + enc_int(5, applied_input_volume)
         + enc_bool(6, keypress))
    for ch in range(capture_in.shape[1]):
        m += enc_bytes(7, np.ascontiguousarray(capture_in[:, ch]).tobytes())
    for ch in range(capture_out.shape[1]):
        m += enc_bytes(8, np.ascontiguousarray(capture_out[:, ch]).tobytes())
    return enc_int(1, STREAM) + enc_bytes(4, m)


# Enum ordinals per the reference declaration order
# (audio_processing.h NoiseSuppression::Level, GainController1::Mode).
NS_LEVELS = ["low", "moderate", "high", "very_high"]
AGC_MODES = ["adaptive_analog", "adaptive_digital", "fixed_digital"]


def config_event(config) -> bytes:
    """Maps the modern Config tree onto the legacy debug.proto Config
    fields, as the reference's WriteConfigMessage does."""
    ec = config.echo_canceller
    gc1 = config.gain_controller1
    m = (enc_bool(1, ec.enabled and not ec.mobile_mode)
         + enc_bool(6, ec.enabled and ec.mobile_mode)
         + enc_bool(9, gc1.enabled)
         + enc_int(10, AGC_MODES.index(gc1.mode.value))
         + enc_bool(11, gc1.enable_limiter)
         + enc_bool(13, config.high_pass_filter.enabled)
         + enc_bool(14, config.noise_suppression.enabled)
         + enc_int(15, NS_LEVELS.index(config.noise_suppression.level.value))
         + enc_bool(16, False)  # transient suppression (deprecated)
         + enc_str(17, "")
         + enc_bool(19, config.pre_amplifier.enabled)
         + enc_float(20, config.pre_amplifier.fixed_gain_factor))
    return enc_int(1, CONFIG) + enc_bytes(5, m)


# RuntimeSetting type -> (debug.proto field, encoder).
_RUNTIME_FIELDS = {
    1: (1, enc_float),   # kCapturePreGain
    5: (2, enc_float),   # kCustomRenderProcessingRuntimeSetting
    3: (3, enc_float),   # kCaptureFixedPostGain
    4: (4, enc_int),     # kPlayoutVolumeChange
    8: (6, enc_bool),    # kCaptureOutputUsed
    7: (7, enc_float),   # kCapturePostGain
}


def runtime_setting_event(setting_type: int, value) -> bytes | None:
    ent = _RUNTIME_FIELDS.get(int(setting_type))
    if ent is None:
        return None
    field, enc = ent
    return enc_int(1, RUNTIME_SETTING) + enc_bytes(6, enc(field, value))


def write_event(fh, event_bytes: bytes) -> None:
    """protobuf_utils.cc framing: int32 LE size prefix per Event."""
    fh.write(struct.pack("<i", len(event_bytes)))
    fh.write(event_bytes)


# ------------------------------------------------------------- decoding

def _read_varint(buf, i):
    x = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        x |= (b & 0x7F) << shift
        if not b & 0x80:
            return x, i
        shift += 7


def _fields(buf):
    i, n = 0, len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        fno, wt = key >> 3, key & 7
        if wt == 0:
            v, i = _read_varint(buf, i)
        elif wt == 5:
            v = struct.unpack_from("<f", buf, i)[0]
            i += 4
        elif wt == 1:
            v = struct.unpack_from("<d", buf, i)[0]
            i += 8
        elif wt == 2:
            ln, i = _read_varint(buf, i)
            v = bytes(buf[i:i + ln])
            i += ln
        else:
            raise ValueError(f"wire type {wt}")
        yield fno, wt, v


def _floats(b: bytes) -> np.ndarray:
    return np.frombuffer(b, np.float32)


def _parse_init(buf):
    d = {"type": INIT}
    names = {1: "sample_rate", 3: "num_input_channels",
             4: "num_output_channels", 5: "num_reverse_channels",
             6: "reverse_sample_rate", 7: "output_sample_rate",
             8: "reverse_output_sample_rate",
             9: "num_reverse_output_channels", 10: "timestamp_ms"}
    for fno, _, v in _fields(buf):
        if fno in names:
            d[names[fno]] = v
    return d


def _parse_reverse(buf):
    d: dict[str, Any] = {"type": REVERSE_STREAM, "channels": []}
    for fno, _, v in _fields(buf):
        if fno == 1:
            d["data_int16"] = np.frombuffer(v, "<i2")
        elif fno == 2:
            d["channels"].append(_floats(v))
    return d


def _parse_stream(buf):
    d: dict[str, Any] = {"type": STREAM, "input_channels": [],
                         "output_channels": []}
    for fno, _, v in _fields(buf):
        if fno == 1:
            d["input_int16"] = np.frombuffer(v, "<i2")
        elif fno == 2:
            d["output_int16"] = np.frombuffer(v, "<i2")
        elif fno == 3:
            d["delay"] = v
        elif fno == 4:
            d["drift"] = (v >> 1) ^ -(v & 1)
        elif fno == 5:
            d["applied_input_volume"] = v
        elif fno == 6:
            d["keypress"] = bool(v)
        elif fno == 7:
            d["input_channels"].append(_floats(v))
        elif fno == 8:
            d["output_channels"].append(_floats(v))
    return d


def _parse_config(buf):
    d = {"type": CONFIG}
    names = {1: "aec_enabled", 5: "aec_suppression_level",
             6: "aecm_enabled", 9: "agc_enabled", 10: "agc_mode",
             11: "agc_limiter_enabled", 13: "hpf_enabled",
             14: "ns_enabled", 15: "ns_level",
             16: "transient_suppression_enabled",
             19: "pre_amplifier_enabled"}
    for fno, wt, v in _fields(buf):
        if fno == 17:
            d["experiments_description"] = v.decode(errors="replace")
        elif fno == 20:
            d["pre_amplifier_fixed_gain_factor"] = v
        elif fno in names:
            d[names[fno]] = v
    return d


def _parse_runtime(buf):
    d = {"type": RUNTIME_SETTING}
    names = {1: "capture_pre_gain", 2: "custom_render_processing_setting",
             3: "capture_fixed_post_gain", 4: "playout_volume_change",
             6: "capture_output_used", 7: "capture_post_gain"}
    for fno, _, v in _fields(buf):
        if fno in names:
            d[names[fno]] = v
    return d


def parse_event(buf: bytes) -> dict:
    ev_type = UNKNOWN_EVENT
    payload = None
    parser = None
    for fno, _, v in _fields(buf):
        if fno == 1:
            ev_type = v
        elif fno == 2:
            payload, parser = v, _parse_init
        elif fno == 3:
            payload, parser = v, _parse_reverse
        elif fno == 4:
            payload, parser = v, _parse_stream
        elif fno == 5:
            payload, parser = v, _parse_config
        elif fno == 6:
            payload, parser = v, _parse_runtime
    if parser is None:
        return {"type": ev_type}
    d = parser(payload)
    d["type"] = ev_type
    return d


def read_dump(path: str) -> list[dict]:
    """Reads a framed .aecdump file into a list of event dicts."""
    events = []
    with open(path, "rb") as fh:
        while True:
            hdr = fh.read(4)
            if len(hdr) < 4:
                break
            (size,) = struct.unpack("<i", hdr)
            if size <= 0:
                break
            buf = fh.read(size)
            if len(buf) < size:
                break
            events.append(parse_event(buf))
    return events
