"""The port's ``api.AudioProcessing`` alone, on the CPU: the counterparts
of tests/test_api_contract.py (error codes, frame sizes, parameter
clamping, config idempotence, format changes, the unmute, the render
output), tests/test_ivc_apm.py, the runtime settings, and what raises."""

import numpy as np
import pytest
import torch

from tests import torch_threads  # noqa: F401  (one thread a worker)
from webrtc_audio_processing_tpu_torch import api
from webrtc_audio_processing_tpu_torch import config as cfg_mod
from webrtc_audio_processing_tpu_torch.api import (
    AudioProcessing,
    RuntimeSetting,
    frame_size,
    kBadDataLengthError,
    kBadNumberChannelsError,
    kBadSampleRateError,
    kBadStreamParameterWarning,
    kNoError,
)

RNG = np.random.default_rng(11)


def ap_cpu(config=None, **kw):
    return AudioProcessing(config or cfg_mod.Config(), device="cpu", **kw)


def _noise(shape, scale=0.1, seed=0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def test_frame_size():
    # GetFrameSize = rate/100 (audio_processing.h:712-719).
    for rate in (8000, 16000, 32000, 48000, 44100):
        assert frame_size(rate) == rate // 100
    assert cfg_mod.NATIVE_SAMPLE_RATES_HZ == (8000, 16000, 32000, 48000)
    assert cfg_mod.MAX_NATIVE_SAMPLE_RATE_HZ == 48000


def test_without_a_card_the_api_raises_unless_given_the_cpu():
    if torch.cuda.is_available():
        assert AudioProcessing().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            AudioProcessing()
    assert ap_cpu().device.type == "cpu"


class TestFormatValidation:
    def test_bad_data_length(self):
        err, _ = ap_cpu().process_stream(np.zeros(100, np.float32), 16000)
        assert err == kBadDataLengthError

    def test_bad_sample_rate(self):
        err, _ = ap_cpu().process_stream(np.zeros(441, np.float32), 44150)
        assert err == kBadSampleRateError

    @pytest.mark.parametrize("rate", [8000, 16000, 32000, 48000])
    def test_native_rates_int16(self, rate):
        ap = ap_cpu(cfg_mod.Config().replace(
            high_pass_filter=cfg_mod.HighPassFilter(enabled=True)))
        x = (RNG.normal(size=frame_size(rate)) * 1000).astype(np.int16)
        err, out = ap.process_stream_int16(x, rate)
        assert err == kNoError
        assert out.dtype == np.int16 and out.shape[0] == frame_size(rate)

    def test_arbitrary_float_rate(self):
        # The float API takes any multiple of 100 (audio_processing.h:554).
        x = _noise(frame_size(44100))
        err, out = ap_cpu().process_stream(x, 44100)
        assert err == kNoError and out.shape[0] == frame_size(44100)


class TestStreamParameters:
    def test_stream_delay_clamping(self):
        ap = ap_cpu()
        assert ap.set_stream_delay_ms(-5) == kBadStreamParameterWarning
        assert ap.stream_delay_ms() == 0
        assert ap.set_stream_delay_ms(600) == kBadStreamParameterWarning
        assert ap.stream_delay_ms() == 500
        assert ap.set_stream_delay_ms(100) == kNoError
        assert ap.stream_delay_ms() == 100
        assert ap.set_stream_delay_ms(-1) == kBadStreamParameterWarning
        assert ap.set_stream_delay_ms(501) == kBadStreamParameterWarning
        assert ap.stream_delay_ms() == 500

    def test_analog_level_clamped(self):
        ap = ap_cpu()
        ap.set_stream_analog_level(300)
        assert ap.recommended_stream_analog_level() == 255
        ap.set_stream_analog_level(-3)
        assert ap.recommended_stream_analog_level() == 0

    def test_no_statistics_before_a_frame(self):
        ap = ap_cpu()
        assert all(v is None for v in vars(ap.get_statistics()).values())
        assert (ap.proc_sample_rate_hz(), ap.num_bands()) == (0, 0)
        assert ap.get_linear_aec_output() is None


class TestConfigIdempotence:
    def test_identical_config_keeps_state(self):
        c = cfg_mod.Config().replace(
            noise_suppression=cfg_mod.NoiseSuppression(enabled=True))
        ap = ap_cpu(c)
        ap.process_stream(_noise(160), 16000)
        state_before = ap._state
        ap.apply_config(c)
        ap.process_stream(_noise(160), 16000)
        assert ap._state.frame_counter == state_before.frame_counter + 1

    def test_changed_config_reinitializes(self):
        ap = ap_cpu()
        ap.process_stream(_noise(160), 16000)
        ap.apply_config(cfg_mod.Config().replace(
            noise_suppression=cfg_mod.NoiseSuppression(enabled=True)))
        err, _ = ap.process_stream(_noise(160), 16000)
        assert err == kNoError
        assert ap._state.ns is not None and ap._state.frame_counter == 1

    def test_format_change_reinitializes(self):
        ap = ap_cpu()
        assert ap.process_stream(_noise(160), 16000)[0] == kNoError
        assert ap.process_stream(_noise(320), 32000)[0] == kNoError
        assert ap.proc_sample_rate_hz() == 32000
        assert ap.process_stream(_noise(160), 16000)[0] == kNoError
        assert ap.proc_sample_rate_hz() == 16000

    def test_initialize_resets_state(self):
        ap = ap_cpu(cfg_mod.Config().replace(
            noise_suppression=cfg_mod.NoiseSuppression(enabled=True)))
        ap.process_stream(_noise(160), 16000)
        ap.initialize()
        err, _ = ap.process_stream(_noise(160), 16000)
        assert err == kNoError and ap._state.frame_counter == 1


@pytest.mark.parametrize("rate", [16000, 32000])
def test_identical_channels_give_identical_outputs(rate):
    """IdenticalInputChannelsResultInIdenticalOutputChannels
    (audio_processing_unittest.cc), bit for bit."""
    ap = ap_cpu(cfg_mod.Config().replace(
        pipeline=cfg_mod.Pipeline(multi_channel_capture=True),
        high_pass_filter=cfg_mod.HighPassFilter(enabled=True),
        noise_suppression=cfg_mod.NoiseSuppression(enabled=True),
        gain_controller2=cfg_mod.GainController2(enabled=True)))
    F = frame_size(rate)
    for k in range(20):
        x = np.repeat(_noise((F, 1), seed=k), 2, axis=1)
        err, out = ap.process_stream(x, rate)
        assert err == kNoError
        np.testing.assert_array_equal(out[:, 0], out[:, 1])


class TestCaptureOutputUsed:
    """kCaptureOutputUsed and the unmute click suppression
    (audio_processing_impl.cc:1046-1057, 1540-1552)."""

    def test_unmute_zeroes_first_frame(self):
        ap = ap_cpu()
        x = _noise((160, 1))
        err, out = ap.process_stream(x, 16000)
        assert err == kNoError and np.abs(out).max() > 0
        ap.set_runtime_setting(
            RuntimeSetting.create_capture_output_used_setting(False))
        assert ap.process_stream(x, 16000)[0] == kNoError
        ap.set_runtime_setting(
            RuntimeSetting.create_capture_output_used_setting(True))
        err, out = ap.process_stream(x, 16000)
        assert err == kNoError and np.abs(out).max() == 0.0
        err, out = ap.process_stream(x, 16000)
        assert np.abs(out).max() > 0.0

    def test_render_output_is_processed_and_returned(self):
        ap = ap_cpu(cfg_mod.Config().replace(
            echo_canceller=cfg_mod.EchoCanceller(enabled=True)))
        ap.process_stream(_noise((160, 1)), 16000)  # the format is known
        r = _noise((160, 1), seed=1)
        err, rout = ap.process_reverse_stream(r, 16000)
        assert err == kNoError and rout.shape == r.shape
        assert isinstance(rout, np.ndarray)
        assert ap._render_queue[0][0] == "bands"
        err, out = ap.process_stream(_noise((160, 1)), 16000)
        assert err == kNoError and not ap._render_queue
        assert ap.get_linear_aec_output().shape == (1, 160)


def test_render_queued_before_the_format_is_dropped_by_the_init():
    """Render pushed before the first capture frame belongs to no format:
    the lazy initialization drops it (AllocateRenderQueue), and the queue
    holds at most 100 frames."""
    ap = ap_cpu(cfg_mod.Config().replace(
        echo_canceller=cfg_mod.EchoCanceller(enabled=True)))
    for k in range(api.RENDER_QUEUE_SIZE_FRAMES + 5):
        assert ap.process_reverse_stream(_noise((160, 1), seed=k),
                                         16000)[0] == kNoError
    assert len(ap._render_queue) == api.RENDER_QUEUE_SIZE_FRAMES
    assert ap.process_stream(_noise((160, 1)), 16000)[0] == kNoError
    assert not ap._render_queue


def test_random_format_transitions():
    """Mid-stream format changes (ChannelCombinations): each reinitializes
    cleanly and gives a well-formed frame."""
    rng = np.random.default_rng(3)
    ap = ap_cpu(cfg_mod.Config().replace(
        noise_suppression=cfg_mod.NoiseSuppression(enabled=True)))
    combos = [(16000, 1), (16000, 2), (32000, 1), (32000, 2)]
    for _ in range(12):
        rate, ch = combos[rng.integers(len(combos))]
        x = (rng.standard_normal((rate // 100, ch)) * 0.1).astype(np.float32)
        err, out = ap.process_stream(x, rate)
        assert err == kNoError, (rate, ch)
        assert out.shape == x.shape and np.all(np.isfinite(out))


def test_analog_level_survives_lazy_initialization():
    """A level set before the first (format-driven) init survives it: with
    AGC2's input volume controller, the first recommendation starts from
    it."""
    ap = ap_cpu(cfg_mod.Config().replace(
        gain_controller2=cfg_mod.GainController2(
            enabled=True,
            input_volume_controller=cfg_mod.InputVolumeController(
                enabled=True))))
    ap.set_stream_analog_level(127)
    err, _ = ap.process_stream(np.zeros((80, 1), np.float32), 8000)
    assert err == 0
    assert ap.recommended_stream_analog_level() == 127


class TestApiMisuseGrid:
    """The misuse permutations of audio_processing_unittest.cc:758-1339
    that apply to this API."""

    def test_zero_channels_rejected(self):
        ap = ap_cpu()
        err, _ = ap.process_stream(np.zeros((160, 0), np.float32), 16000)
        assert err == kBadNumberChannelsError
        err, _ = ap.process_reverse_stream(np.zeros((160, 0), np.float32),
                                           16000)
        assert err == kBadNumberChannelsError

    @pytest.mark.parametrize("rate", [8000, 12000, 16000, 32000, 44100,
                                      48000, 96000])
    def test_float_rate_sweep(self, rate):
        ap = ap_cpu(cfg_mod.Config().replace(
            noise_suppression=cfg_mod.NoiseSuppression(enabled=True)))
        x = _noise((rate // 100, 2))
        err, out = ap.process_stream(x, rate)
        assert err == kNoError
        assert out.shape == x.shape and np.all(np.isfinite(out))

    def test_all_processing_disabled_passthrough_int16(self):
        """NoProcessingWhenAllComponentsDisabledInt: bit-exact."""
        ap = ap_cpu()
        x = (RNG.normal(size=(160, 2)) * 8000).astype(np.int16)
        for _ in range(3):
            err, out = ap.process_stream_int16(x, 16000)
            assert err == kNoError
            np.testing.assert_array_equal(out, x)

    def test_forward_channel_counts(self):
        ap = ap_cpu()
        for n in (1, 2):
            err, out = ap.process_stream(_noise((160, n)), 16000)
            assert err == kNoError and out.shape[1] == n


# ---------------------------------------------------------- runtime settings


def _levels(pre_amp=False, cla=False, agc2=False):
    return cfg_mod.Config().replace(
        pre_amplifier=cfg_mod.PreAmplifier(enabled=pre_amp),
        capture_level_adjustment=cfg_mod.CaptureLevelAdjustment(enabled=cla),
        gain_controller2=cfg_mod.GainController2(enabled=agc2))


def _gain_after(ap, setting, frames=3):
    """Output over input RMS after ``setting``, from the second frame on
    (the first ramps)."""
    x = _noise((160, 1), scale=0.01)
    ap.process_stream(x, 16000)
    ap.set_runtime_setting(setting)
    outs = [ap.process_stream(x, 16000)[1] for _ in range(frames)]
    return float(np.sqrt(np.mean(outs[-1] ** 2) / np.mean(x ** 2)))


@pytest.mark.parametrize("name,config,setting,gain", [
    ("pre_amplifier", _levels(pre_amp=True),
     RuntimeSetting.create_capture_pre_gain(2.0), 2.0),
    ("levels_pre", _levels(cla=True),
     RuntimeSetting.create_capture_pre_gain(3.0), 3.0),
    ("levels_post", _levels(cla=True),
     RuntimeSetting.create_capture_post_gain(0.5), 0.5),
    ("fixed_post_gain", _levels(agc2=True),
     RuntimeSetting.create_capture_fixed_post_gain(6.0), 10 ** (6 / 20)),
    ("pre_gain_ignored", _levels(),
     RuntimeSetting.create_capture_pre_gain(2.0), 1.0),
    ("compression_ignored", _levels(),
     RuntimeSetting.create_compression_gain_db(9), 1.0),
    ("playout_volume", _levels(),
     RuntimeSetting.create_playout_volume_change(80), 1.0),
    ("custom_render", _levels(),
     RuntimeSetting.create_custom_render_setting(3), 1.0),
])
def test_runtime_setting_applies_its_gain(name, config, setting, gain):
    """Each capture gain setting takes effect within a frame and keeps the
    stream's state; the others are accepted and change nothing."""
    ap = ap_cpu(config)
    assert _gain_after(ap, setting) == pytest.approx(gain, rel=2e-3)
    assert ap._state.frame_counter == 4


def test_runtime_pre_gain_ramps_within_the_frame():
    ap = ap_cpu(_levels(pre_amp=True))
    x = np.full((160, 1), 0.01, np.float32)
    ap.process_stream(x, 16000)
    ap.set_runtime_setting(RuntimeSetting.create_capture_pre_gain(2.0))
    _, y = ap.process_stream(x, 16000)
    assert y[0, 0] < y[-1, 0]
    assert y[-1, 0] == pytest.approx(0.02, rel=1e-5)


# --------------------------------------------------------------- raising


@pytest.mark.parametrize("what", ["aec_dump"])
def test_unported_parts_raise_naming_their_roadmap_item(what, tmp_path):
    """Nothing is left unported: the AEC dump (ROADMAP Queue 1 item 12c,
    the last part that raised) attaches and records, and no module of the
    port raises NotImplementedError naming a ROADMAP Queue 1 item."""
    import pathlib
    import re

    import webrtc_audio_processing_tpu_torch as pkg

    path = tmp_path / "dump.aecdump"
    ap = ap_cpu()
    assert ap.attach_aec_dump(str(path)) == api.kNoError
    assert ap.detach_aec_dump() == api.kNoError
    assert path.stat().st_size > 0
    pattern = re.compile(r"NotImplementedError\([^)]*Queue 1", re.S)
    root = pathlib.Path(pkg.__file__).parent
    raising = [str(f.relative_to(root)) for f in sorted(root.rglob("*.py"))
               if pattern.search(f.read_text())]
    assert raising == [], (what, raising)


def test_ring_dtype_other_than_float32_raises(monkeypatch):
    """``APM_AEC3_RING_DTYPE=bfloat16`` stores AEC3's render rings in bf16
    (it once raised): the API builds them and runs a frame; any dtype but
    float32 and bfloat16 raises ValueError naming the two."""
    monkeypatch.setenv("APM_AEC3_RING_DTYPE", "bfloat16")
    ap = ap_cpu(cfg_mod.Config().replace(
        echo_canceller=cfg_mod.EchoCanceller(enabled=True)))
    ap.process_reverse_stream(_noise((160, 1), seed=1), 16000)
    err, out = ap.process_stream(_noise((160, 1)), 16000)
    assert err == 0 and out.shape == (160, 1) and np.isfinite(out).all()
    assert ap._geo.aec3.buffer.ring_dtype == "bfloat16"
    assert ap._state.aec.buffer.sf.dtype == torch.bfloat16


def test_ring_dtype_env_outside_the_two_raises_value_error(monkeypatch):
    monkeypatch.setenv("APM_AEC3_RING_DTYPE", "float16")
    ap = ap_cpu(cfg_mod.Config().replace(
        echo_canceller=cfg_mod.EchoCanceller(enabled=True)))
    with pytest.raises(ValueError, match="'float32' or 'bfloat16'"):
        ap.process_stream(_noise((160, 1)), 16000)


def test_pair_kernel_switch_selects_k6(monkeypatch):
    monkeypatch.setenv("AEC3_PAIR_KERNEL", "1")
    ap = ap_cpu(cfg_mod.Config().replace(
        echo_canceller=cfg_mod.EchoCanceller(enabled=True)))
    ap.process_stream(_noise((160, 1)), 16000)
    assert ap._geo.aec3.pair_kernel


def test_pair_phase_switch_selects_the_per_block_path(monkeypatch):
    """``AEC3_PAIR_PHASE=0``, the JAX package's switch, runs AEC3's
    per-block path; unset, the pair-phase one."""
    ap = ap_cpu(cfg_mod.Config().replace(
        echo_canceller=cfg_mod.EchoCanceller(enabled=True)))
    ap.process_stream(_noise((160, 1)), 16000)
    assert ap._geo.aec3.pair_phase
    monkeypatch.setenv("AEC3_PAIR_PHASE", "0")
    ap = ap_cpu(cfg_mod.Config().replace(
        echo_canceller=cfg_mod.EchoCanceller(enabled=True)))
    err, out = ap.process_stream(_noise((160, 1)), 16000)
    assert err == 0 and np.isfinite(out).all()
    assert not ap._geo.aec3.pair_phase


# ------------------------------------ the input volume controller (AGC2)


def _speech(n, fs, amp):
    """Voiced-speech-like: a pitch-vibrato sawtooth with a slow amplitude
    swing (tests/test_ivc_apm.py), which the RNN-VAD takes for speech."""
    t = np.arange(n) / fs
    f0 = 120 * (1 + 0.06 * np.sin(2 * np.pi * 3.1 * t))
    phase = 2 * np.pi * np.cumsum(f0) / fs
    saw = sum((1.0 / k) * np.sin(k * phase) for k in range(1, 12))
    x = saw * (0.6 + 0.4 * np.sin(2 * np.pi * 1.7 * t))
    return (amp * x / np.abs(x).max()).astype(np.float32)


@pytest.mark.parametrize("amp,start,moves", [
    (0.003, 80, lambda v: v > 80),  # ~-50 dBFS speech: volume up
    (0.5, 200, lambda v: v < 200),  # ~-6 dBFS speech: volume down
], ids=["quiet_speech_up", "loud_speech_down"])
def test_recommended_volume_follows_the_speech_level(amp, start, moves):
    fs = 16000
    ap = ap_cpu(cfg_mod.Config().replace(
        gain_controller2=cfg_mod.GainController2(
            enabled=True,
            input_volume_controller=cfg_mod.InputVolumeController(
                enabled=True),
            adaptive_digital=cfg_mod.AdaptiveDigital(enabled=True))))
    x = _speech(fs * 5 // 2, fs, amp)  # the first update comes at frame 99
    F, level = fs // 100, start
    for k in range(x.size // F):
        ap.set_stream_analog_level(level)
        err, _ = ap.process_stream(x[k * F:(k + 1) * F], fs)
        assert err == 0
        level = ap.recommended_stream_analog_level()
    assert moves(level), level
