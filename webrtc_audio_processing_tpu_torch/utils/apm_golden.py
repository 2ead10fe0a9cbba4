"""Reader for the reference APM conformance goldens (ApmTest.Process).

The port's own copy of ``webrtc_audio_processing_tpu/utils/apm_golden.py``
(pure Python and numpy; nothing of it is shared with the JAX package).

Parses tests/resources/audio_processing/output_data_float.pb — schema
tests/proto/unittest.proto (proto2, message OutputData { repeated Test }) —
with a minimal hand-rolled wire-format decoder (no protoc dependency).

Reference: tests/unit/audio_processing_unittest.cc:1698-1875 (the harness
that produced the file: all components on, per-second echo metrics,
analog-level and max-output averages per configuration).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field


def _varint(buf, i):
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
    """Yields (field_number, wire_type, value) over a message buffer."""
    i = 0
    n = len(buf)
    while i < n:
        key, i = _varint(buf, i)
        fno, wt = key >> 3, key & 7
        if wt == 0:
            v, i = _varint(buf, i)
        elif wt == 5:
            v = struct.unpack_from("<f", buf, i)[0]
            i += 4
        elif wt == 1:
            v = struct.unpack_from("<d", buf, i)[0]
            i += 8
        elif wt == 2:
            ln, i = _varint(buf, i)
            v = buf[i : i + ln]
            i += ln
        else:
            raise ValueError(f"wire type {wt}")
        yield fno, wt, v


@dataclass
class EchoMetrics:
    echo_return_loss: float = 0.0
    echo_return_loss_enhancement: float = 0.0
    divergent_filter_fraction: float = 0.0
    residual_echo_likelihood: float = 0.0
    residual_echo_likelihood_recent_max: float = 0.0


@dataclass
class GoldenTest:
    num_reverse_channels: int = 0
    num_input_channels: int = 0
    num_output_channels: int = 0
    sample_rate: int = 0
    analog_level_average: int = 0
    max_output_average: int = 0
    has_voice_count: int = 0
    is_saturated_count: int = 0
    rms_dbfs_average: float = 0.0
    ns_speech_probability_average: float = 0.0
    use_aec_extended_filter: bool = False
    echo_metrics: list = field(default_factory=list)
    delay_metrics: list = field(default_factory=list)


def _parse_echo(buf) -> EchoMetrics:
    m = EchoMetrics()
    for fno, _, v in _fields(buf):
        if fno == 1:
            m.echo_return_loss = v
        elif fno == 2:
            m.echo_return_loss_enhancement = v
        elif fno == 3:
            m.divergent_filter_fraction = v
        elif fno == 4:
            m.residual_echo_likelihood = v
        elif fno == 5:
            m.residual_echo_likelihood_recent_max = v
    return m


def _parse_test(buf) -> GoldenTest:
    t = GoldenTest()
    for fno, _, v in _fields(buf):
        if fno == 1:
            t.num_reverse_channels = v
        elif fno == 2:
            t.num_input_channels = v
        elif fno == 3:
            t.num_output_channels = v
        elif fno == 4:
            t.sample_rate = v
        elif fno == 6:
            t.analog_level_average = v
        elif fno == 7:
            t.max_output_average = v
        elif fno == 9:
            t.has_voice_count = v
        elif fno == 10:
            t.is_saturated_count = v
        elif fno == 11:
            t.echo_metrics.append(_parse_echo(v))
        elif fno == 12:
            dm = {}
            for f2, _, v2 in _fields(v):
                dm[{1: "median", 2: "std"}.get(f2, f2)] = v2
            t.delay_metrics.append(dm)
        elif fno == 13:
            t.rms_dbfs_average = v
        elif fno == 14:
            t.ns_speech_probability_average = v
        elif fno == 15:
            t.use_aec_extended_filter = bool(v)
    return t


def read_output_data(path) -> list[GoldenTest]:
    buf = open(path, "rb").read()
    # The writer (tests/test_utils/protobuf_utils.cc WriteMessage) prefixes
    # the serialized proto with a uint32 little-endian byte count.
    if len(buf) >= 4:
        (size,) = struct.unpack_from("<I", buf, 0)
        if size == len(buf) - 4:
            buf = buf[4:]
    tests = []
    for fno, _, v in _fields(buf):
        if fno == 1:
            tests.append(_parse_test(v))
    return tests
