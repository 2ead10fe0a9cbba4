"""The port's host primitives against their JAX twins on the CPU.

The ring buffer, the smoothing filter, the FIR filter, the AudioFrame
proxies, the audio converter and the goldens' reader, each fed the same
seeded numpy inputs as its JAX twin (tests/test_primitives_and_metrics.py's
cases and a few more). The pure-Python copies must agree exactly; the FIR
filter follows XLA:CPU's contracted order (bit for bit at 3 taps or more,
held to 1e-6 at 2); the converter's resampler is the port's own op, held
to 1e-6.
"""

import math
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_threads  # noqa: F401  (one thread a worker)
from webrtc_audio_processing_tpu import api as j_api
from webrtc_audio_processing_tpu import config as j_cfg
from webrtc_audio_processing_tpu.ops import fir_filter as j_fir
from webrtc_audio_processing_tpu.utils import apm_golden as j_golden
from webrtc_audio_processing_tpu.utils import audio_converter as j_conv
from webrtc_audio_processing_tpu.utils import audio_frame as j_frame
from webrtc_audio_processing_tpu.utils import ring_buffer as j_ring
from webrtc_audio_processing_tpu.utils import smoothing_filter as j_smooth

from webrtc_audio_processing_tpu_torch import api
from webrtc_audio_processing_tpu_torch import config as cfg_mod
from webrtc_audio_processing_tpu_torch.ops import fir_filter
from webrtc_audio_processing_tpu_torch.utils import (
    apm_golden,
    audio_converter,
    audio_frame,
    ring_buffer,
    smoothing_filter,
)


# ------------------------------------------------------------ ring buffer


def _ring_script(mod):
    """tests/test_primitives_and_metrics.py's wrap and stuffing case, then
    an over-fill and a flush, every read and count recorded."""
    rb = mod.RingBuffer(8)
    log = [rb.available_write(), rb.write(np.arange(5, dtype=np.float32)),
           rb.available_read(), rb.read(3).tolist(),
           rb.write(np.arange(10, 15, dtype=np.float32)), rb.available_read(),
           rb.read(7).tolist(), rb.move_read_ptr(-4), rb.available_read(),
           rb.read(4).tolist(), rb.write(np.ones(10, np.float32)),
           rb.available_write(), rb.move_read_ptr(3), rb.read(8).tolist(),
           rb.move_read_ptr(-20), rb.available_read()]
    vec = mod.RingBuffer(4, element_shape=(2,), dtype=np.int16)
    log += [vec.write(np.arange(6, dtype=np.int16).reshape(3, 2)),
            vec.read(2).tolist(), vec.write(np.ones((3, 2), np.int16)),
            vec.read(4).tolist()]
    vec.init()
    log.append(vec.available_read())
    return log


def test_ring_buffer_matches_jax_twin():
    assert _ring_script(ring_buffer) == _ring_script(j_ring)


# ------------------------------------------------------- smoothing filter


@pytest.mark.parametrize("init_time_ms", [0, 1, 100])
def test_smoothing_filter_matches_jax_twin(init_time_ms):
    rng = np.random.default_rng(0)
    xs = rng.normal(size=400).astype(np.float32)
    times = np.cumsum(rng.integers(1, 4, size=400))
    got, want = (m.SmoothingFilter(init_time_ms=init_time_ms)
                 for m in (smoothing_filter, j_smooth))
    for f in (got, want):
        assert f.get_average(0) is None
    for t, x in zip(times.tolist(), xs.tolist()):
        got.add_sample(x, t)
        want.add_sample(x, t)
        if t % 7 == 0:
            assert got.get_average(t + 1) == want.get_average(t + 1)
        assert got.set_time_constant_ms(50) == want.set_time_constant_ms(50)
    assert got.alpha == want.alpha
    assert got.get_average(int(times[-1]) + 500) == want.get_average(
        int(times[-1]) + 500)


def test_smoothing_filter_post_init_recursion():
    """tests/test_primitives_and_metrics.py's case on the port's copy."""
    f = smoothing_filter.SmoothingFilter(init_time_ms=100)
    rng = np.random.default_rng(0)
    for t, x in enumerate(rng.normal(size=400).astype(np.float32)):
        f.add_sample(float(x), t)
    assert abs(f.alpha - math.exp(-1.0 / 100)) < 1e-6
    assert np.isfinite(f.get_average(399))
    f3 = smoothing_filter.SmoothingFilter(init_time_ms=0)
    f3.add_sample(5.0, 0)
    assert abs(f3.get_average(1000) - 5.0) < 1e-6


# ------------------------------------------------------------- FIR filter


def _jax_chunks(coeffs, x, chunk):
    st = j_fir.init_state(coeffs)
    f = jax.jit(lambda s, c: j_fir.filter(coeffs, s, c))
    ys = []
    for k in range(0, len(x), chunk):
        y, st = f(st, jnp.asarray(x[k:k + chunk]))
        ys.append(np.asarray(y))
    return np.concatenate(ys)


def _port_chunks(coeffs, x, chunk, batch=1):
    st = fir_filter.init_state(coeffs, "cpu", batch)
    xb = torch.from_numpy(np.repeat(x[None], batch, axis=0))
    ys = []
    for k in range(0, x.shape[0], chunk):
        y, st = fir_filter.filter(coeffs, st, xb[:, k:k + chunk])
        ys.append(y)
    return torch.cat(ys, dim=1).numpy()


@pytest.mark.parametrize("taps,seed", [(7, 1), (3, 2), (16, 0), (2, 1),
                                       (1, 3)])
def test_fir_filter_streaming_matches_batch_and_jax(taps, seed):
    rng = np.random.default_rng(seed)
    coeffs = rng.normal(size=taps).astype(np.float32)
    x = rng.normal(size=(200,)).astype(np.float32)
    got = _port_chunks(coeffs, x, 40, batch=3)
    np.testing.assert_allclose(got[0], np.convolve(x, coeffs)[:200],
                               atol=1e-5)
    np.testing.assert_array_equal(got[1], got[0])
    np.testing.assert_array_equal(_port_chunks(coeffs, x, 200)[0], got[0])
    want = _jax_chunks(coeffs, x, 40)
    if taps >= 3:
        np.testing.assert_array_equal(got[0], want)
    else:
        np.testing.assert_allclose(got[0], want, rtol=0, atol=1e-6)


# -------------------------------------------------------- AudioFrame


def test_audio_frame_container_matches_jax_twin():
    rng = np.random.default_rng(4)
    data = rng.integers(-32768, 32767, size=(480, 2)).astype(np.int16)
    frames = [m.AudioFrame(48000, 2) for m in (audio_frame, j_frame)]
    for f in frames:
        assert f.muted() and f.samples_per_channel == 480
        f.update_frame(48000, 2, data.reshape(-1))
        assert not f.muted()
    np.testing.assert_array_equal(frames[0].interleaved(),
                                  frames[1].interleaved())
    for f in frames:
        f.set_interleaved(data[::-1].reshape(-1))
    np.testing.assert_array_equal(frames[0].data(), frames[1].data())
    assert (audio_frame.NO_ERROR, audio_frame.NULL_POINTER_ERROR,
            audio_frame.BAD_SAMPLE_RATE_ERROR,
            audio_frame.BAD_NUMBER_CHANNELS_ERROR) == (
        j_frame.NO_ERROR, j_frame.NULL_POINTER_ERROR,
        j_frame.BAD_SAMPLE_RATE_ERROR, j_frame.BAD_NUMBER_CHANNELS_ERROR)


def test_audio_frame_round_trip_through_both_apis():
    """tests/test_primitives_and_metrics.py's case (a 1 kHz tone through
    the HPF at 16 kHz): the port's int16 output within one int16 step of
    JAX's, the error codes the same."""
    c = [m.Config().replace(high_pass_filter=m.HighPassFilter(enabled=True))
         for m in (cfg_mod, j_cfg)]
    aps = (api.AudioProcessing(c[0], device="cpu"),
           j_api.AudioProcessing(c[1]))
    t = np.arange(160) / 16000.0
    sig = (np.sin(2 * np.pi * 1000 * t) * 8000).astype(np.int16)
    outs = []
    for mod, ap in zip((audio_frame, j_frame), aps):
        fr = mod.AudioFrame(16000, 1)
        fr.update_frame(16000, 1, sig[:, None])
        assert mod.process_audio_frame(ap, fr) == mod.NO_ERROR
        outs.append(fr.data()[:, 0].astype(np.int32))
        assert np.abs(outs[-1]).max() > 100  # 1 kHz passes the HPF
        rf = mod.AudioFrame(16000, 1)
        rf.update_frame(16000, 1, sig[:, None])
        assert mod.process_reverse_audio_frame(ap, rf) == mod.NO_ERROR
        bad = mod.AudioFrame(16000, 1)
        bad.sample_rate_hz = 44100
        assert (mod.process_reverse_audio_frame(ap, bad)
                == mod.BAD_SAMPLE_RATE_ERROR)
        bad = mod.AudioFrame(16000, 1)
        bad.num_channels = 0
        assert (mod.process_reverse_audio_frame(ap, bad)
                == mod.BAD_NUMBER_CHANNELS_ERROR)
        assert mod.process_audio_frame(None, fr) == mod.NULL_POINTER_ERROR
    assert np.abs(outs[0] - outs[1]).max() <= 1


# ------------------------------------------------------ AudioConverter


@pytest.mark.parametrize("src_ch,src_frames,dst_ch,dst_frames", [
    (2, 480, 1, 160),   # downmix, then resample
    (1, 160, 2, 160),   # upmix only
    (1, 160, 2, 480),   # resample, then upmix
    (2, 480, 2, 320),   # resample both channels
    (4, 160, 2, 160),   # downmix to stereo (the average on both)
])
def test_audio_converter_matches_jax_twin(src_ch, src_frames, dst_ch,
                                          dst_frames):
    rng = np.random.default_rng(src_ch * 1000 + dst_frames)
    got = audio_converter.AudioConverter(src_ch, src_frames, dst_ch,
                                         dst_frames, device="cpu")
    want = j_conv.AudioConverter(src_ch, src_frames, dst_ch, dst_frames)
    for _ in range(6):
        x = rng.normal(size=(src_frames, src_ch)).astype(np.float32)
        g, w = got.convert(x), want.convert(x)
        assert g.shape == w.shape == (dst_frames, dst_ch)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


def test_audio_converter_batched_step_and_tone():
    """Stereo 48 kHz -> mono 16 kHz for B = 3 streams in one step, each
    the one-stream converter's output; a 1 kHz tone keeps its amplitude
    and frequency (tests/test_primitives_and_metrics.py's case)."""
    conv = audio_converter.AudioConverter(2, 480, 1, 160, batch=3,
                                          device="cpu")
    one = audio_converter.AudioConverter(2, 480, 1, 160, device="cpu")
    t = np.arange(480 * 20) / 48000.0
    sig = np.sin(2 * np.pi * 1000 * t).astype(np.float32)
    outs = []
    for k in range(20):
        frame = np.stack([sig[k * 480:(k + 1) * 480]] * 2, axis=1)
        x = torch.from_numpy(np.stack([frame, 0.5 * frame, -frame]))
        y = conv.step(x)
        assert tuple(y.shape) == (3, 160, 1)
        np.testing.assert_array_equal(y[0].numpy(), one.convert(frame))
        outs.append(y[:, :, 0].numpy())
    y = np.concatenate(outs, axis=1)[:, 800:]
    assert 0.8 < np.abs(y[0]).max() < 1.2
    np.testing.assert_allclose(y[1], 0.5 * y[0], rtol=0, atol=1e-6)
    freq = np.sum(np.diff(np.signbit(y[0]))) / 2 / (y.shape[1] / 16000)
    assert 950 < freq < 1050
    with pytest.raises(ValueError):
        audio_converter.AudioConverter(2, 160, 4, 160, device="cpu")
    with pytest.raises(ValueError):
        conv.step(torch.zeros(2, 480, 2))


# ------------------------------------------------------- goldens' reader


def _varint(x):
    out = bytearray()
    while True:
        b = x & 0x7F
        x >>= 7
        out.append(b | (0x80 if x else 0))
        if not x:
            return bytes(out)


def _field(fno, wt, payload):
    return _varint((fno << 3) | wt) + payload


def _golden_bytes(framed):
    """An OutputData message of two Tests in unittest.proto's schema, with
    the writer's uint32 size prefix when ``framed``."""
    def test_msg(k):
        m = b"".join(_field(f, 0, _varint(v)) for f, v in (
            (1, 2), (2, 1 + k), (3, 1), (4, 16000 * (k + 1)), (6, 120),
            (7, 9000 + k), (9, 33), (10, 2), (15, k)))
        echo = b"".join(_field(f, 5, struct.pack("<f", v)) for f, v in (
            (1, 12.5), (2, 3.25), (3, 0.125), (4, 0.5), (5, 0.75)))
        m += _field(11, 2, _varint(len(echo)) + echo)
        delay = _field(1, 0, _varint(64)) + _field(2, 0, _varint(3))
        m += _field(12, 2, _varint(len(delay)) + delay)
        m += _field(13, 5, struct.pack("<f", -21.5))
        m += _field(14, 5, struct.pack("<f", 0.875))
        m += _field(16, 1, struct.pack("<d", 1.0))  # a field neither knows
        return m

    body = b"".join(_field(1, 2, _varint(len(m)) + m)
                    for m in (test_msg(0), test_msg(1)))
    return struct.pack("<I", len(body)) + body if framed else body


@pytest.mark.parametrize("framed", [True, False])
def test_golden_reader_matches_jax_twin(tmp_path, framed):
    path = tmp_path / "output_data_float.pb"
    path.write_bytes(_golden_bytes(framed))
    got = apm_golden.read_output_data(str(path))
    want = j_golden.read_output_data(str(path))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert repr(g) == repr(w)
    assert got[1].sample_rate == 32000 and got[1].num_input_channels == 2
    assert got[0].echo_metrics[0].echo_return_loss == 12.5
    assert got[0].delay_metrics == [{"median": 64, "std": 3}]
    assert got[1].use_aec_extended_filter is True
