"""The port's AEC dump against the JAX package's on the CPU.

The wire codec (``utils/debug_proto.py``) must give byte-identical bytes
for the same events, and each package's reader must decode the other's
files to equal events, the legacy ``.npz`` container included. Through
the API (``tests/torch_jax_api_run.py``'s sessions: 16 kHz mono, AEC3, NS
and AGC2, 12 frames): the port replays the JAX package's recording within
relative RMS 1e-3 a frame of the outputs JAX recorded (which JAX's own
replay reproduces bit for bit, tests/test_aec_dump.py), and its own
recording bit for bit.
"""

import json
import os

import numpy as np
import pytest

from tests import torch_jax_api_run as run
from tests import torch_threads  # noqa: F401  (one thread a worker)
from webrtc_audio_processing_tpu import config as j_cfg
from webrtc_audio_processing_tpu.utils import aec_dump as j_dump
from webrtc_audio_processing_tpu.utils import debug_proto as j_dp

from webrtc_audio_processing_tpu_torch import api
from webrtc_audio_processing_tpu_torch import config as cfg_mod
from webrtc_audio_processing_tpu_torch.utils import aec_dump, debug_proto as dp

RNG_SEED = 37


def _configs(m):
    return {
        "default": m.Config(),
        "ns_high_preamp": m.Config().replace(
            noise_suppression=m.NoiseSuppression(
                enabled=True, level=m.NoiseSuppressionLevel.HIGH),
            pre_amplifier=m.PreAmplifier(enabled=True,
                                         fixed_gain_factor=1.5)),
        "aecm_agc1": m.Config().replace(
            echo_canceller=m.EchoCanceller(enabled=True, mobile_mode=True),
            gain_controller1=m.GainController1(
                enabled=True, mode=m.Agc1Mode.FIXED_DIGITAL,
                enable_limiter=False),
            high_pass_filter=m.HighPassFilter(enabled=True)),
        "aec3_ns_very_high": m.Config().replace(
            echo_canceller=m.EchoCanceller(enabled=True),
            noise_suppression=m.NoiseSuppression(
                enabled=True, level=m.NoiseSuppressionLevel.VERY_HIGH)),
    }


def _events(mod, case):
    """The bytes of one event kind from the codec module ``mod``, from
    inputs made from a seed."""
    rng = np.random.default_rng(RNG_SEED)
    ren = rng.normal(size=(480, 2)).astype(np.float32)
    cap_in = rng.normal(size=(160, 1)).astype(np.float32)
    cap_out = rng.normal(size=(160, 1)).astype(np.float32)
    if case == "init":
        return mod.init_event(48000, 2, 2, 2, 48000, 48000, timestamp_ms=7)
    if case == "reverse_stereo":
        return mod.reverse_stream_event(ren)
    if case == "reverse_mono":
        return mod.reverse_stream_event(ren[:160, :1])
    if case == "stream":
        return mod.stream_event(cap_in, cap_out, 30, 120, True)
    if case == "stream_negative_delay":
        return mod.stream_event(cap_in, cap_out, -5, 0, False)
    if case.startswith("config_"):
        cfgs = _configs(j_cfg if mod is j_dp else cfg_mod)
        return mod.config_event(cfgs[case[len("config_"):]])
    if case.startswith("runtime_"):
        kind, value = {"runtime_pre_gain": (1, 2.0),
                       "runtime_post_gain": (7, 0.5),
                       "runtime_fixed_post_gain": (3, 6.0),
                       "runtime_playout_volume": (4, 77),
                       "runtime_custom_render": (5, 3.0),
                       "runtime_output_used": (8, False),
                       "runtime_compression_gain": (2, 9.0)}[case]
        return mod.runtime_setting_event(kind, value)
    raise KeyError(case)


CASES = ["init", "reverse_stereo", "reverse_mono", "stream",
         "stream_negative_delay", "config_default", "config_ns_high_preamp",
         "config_aecm_agc1", "config_aec3_ns_very_high", "runtime_pre_gain",
         "runtime_post_gain", "runtime_fixed_post_gain",
         "runtime_playout_volume", "runtime_custom_render",
         "runtime_output_used", "runtime_compression_gain"]


@pytest.mark.parametrize("case", CASES)
def test_events_encode_byte_identical(case):
    """The same event gives the same bytes from both codecs (a runtime
    setting the proto has no field for gives None in both)."""
    want, got = _events(j_dp, case), _events(dp, case)
    assert got == want
    if got is not None:
        assert dp.parse_event(got).keys() == j_dp.parse_event(want).keys()


def _write(mod, path, cases):
    with open(path, "wb") as fh:
        for case in cases:
            ev = _events(mod, case)
            if ev is not None:
                mod.write_event(fh, ev)


def _assert_events_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k, v in w.items():
            if isinstance(v, list):
                assert len(g[k]) == len(v)
                for a, b in zip(g[k], v):
                    np.testing.assert_array_equal(a, b)
            elif isinstance(v, np.ndarray):
                np.testing.assert_array_equal(g[k], v)
            else:
                assert g[k] == v, k


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_reader_decodes_the_other_packages_file(tmp_path, writer):
    """A file framed and written by one package reads to equal events
    through both readers."""
    path = str(tmp_path / "x.aecdump")
    _write(j_dp if writer == "jax" else dp, path, CASES)
    with open(path, "rb") as fh:
        raw = fh.read()
    other = str(tmp_path / "y.aecdump")
    _write(dp if writer == "jax" else j_dp, other, CASES)
    with open(other, "rb") as fh:
        assert fh.read() == raw
    _assert_events_equal(dp.read_dump(path), j_dp.read_dump(path))
    _assert_events_equal(aec_dump.load_dump(path), j_dump.load_dump(path))


def _legacy_npz(path, config_json):
    """A legacy .npz container: the events as JSON under ``__events__``,
    the frames as arrays, RUNTIME_SETTING numbered 4."""
    rng = np.random.default_rng(5)
    arrays, events = {}, [{"type": 0, "sample_rate": 16000,
                           "num_input_channels": 1,
                           "num_reverse_channels": 1,
                           "reverse_sample_rate": 16000},
                          {"type": 3, "config": config_json}]
    for k in range(3):
        arrays[f"r{k}"] = (0.1 * rng.standard_normal((160, 1))).astype(
            np.float32)
        arrays[f"i{k}"] = (0.1 * rng.standard_normal((160, 1))).astype(
            np.float32)
        arrays[f"o{k}"] = np.zeros((160, 1), np.float32)
        events += [{"type": 1, "data": f"r{k}"},
                   {"type": 2, "input": f"i{k}", "output": f"o{k}",
                    "delay": 10, "applied_input_volume": 0,
                    "keypress": False}]
    events.append({"type": 4, "setting_type": 1, "value": 1.0})
    arrays["__events__"] = np.frombuffer(json.dumps(events).encode(),
                                         np.uint8)
    np.savez(path, **arrays)


def _config_json():
    return json.dumps({
        "high_pass_filter": {"enabled": True},
        "noise_suppression": {"enabled": True, "level": "high"},
        "pre_amplifier": {"enabled": True, "fixed_gain_factor": 1.0},
    })


def test_legacy_npz_container_reads_as_jax_reads_it(tmp_path):
    path = str(tmp_path / "legacy.npz")
    _legacy_npz(path, _config_json())
    _assert_events_equal(aec_dump.load_dump(path), j_dump.load_dump(path))
    got = aec_dump._config_from_json(cfg_mod, _config_json())
    want = j_dump._config_from_json(j_cfg, _config_json())
    assert repr(got) == repr(want)
    assert got.noise_suppression.level is cfg_mod.NoiseSuppressionLevel.HIGH


def test_legacy_npz_replays_on_the_port(tmp_path):
    """The legacy container replays through the port's API with the
    config snapshot it holds (HPF, NS high, the pre-amplifier), bit for bit
    the port's direct run of the same frames."""
    path = str(tmp_path / "legacy.npz")
    _legacy_npz(path, _config_json())
    pairs = aec_dump.replay(path, device="cpu")
    events = aec_dump.load_dump(path)
    ap = api.AudioProcessing(
        aec_dump._config_from_json(cfg_mod, _config_json()), device="cpu")
    direct = []
    for ev in events:
        if ev["type"] == dp.REVERSE_STREAM:
            ap.process_reverse_stream(np.stack(ev["channels"], -1), 16000)
        elif ev["type"] == dp.STREAM:
            ap.set_stream_delay_ms(ev["delay"])
            ap.set_stream_analog_level(0)
            direct.append(ap.process_stream(
                np.stack(ev["input_channels"], -1), 16000)[1])
    assert len(pairs) == len(direct) == 3
    for (_, replayed), want in zip(pairs, direct):
        np.testing.assert_array_equal(replayed, want)


def test_port_replays_the_jax_recording():
    """The JAX package's API dump (attached before the first frame, so no
    INIT event: 16 kHz is the replay's default) through the port's replay
    with the session's config: each frame within relative RMS 1e-3 of
    what JAX recorded."""
    jx = run.jax_session()
    pairs = aec_dump.replay(jx["dump"], config=run.config(cfg_mod),
                            device="cpu")
    assert len(pairs) == run.N_FRAMES
    for k, (recorded, replayed) in enumerate(pairs):
        np.testing.assert_array_equal(recorded, jx["out"][k])
        assert run.rel_rms(replayed, recorded) <= run.RTOL_RMS, k


def test_port_replay_is_bit_equal_to_its_direct_run():
    po = run.port_session()
    pairs = aec_dump.replay(po["dump"], config=run.config(cfg_mod),
                            device="cpu")
    assert len(pairs) == run.N_FRAMES
    for k, (recorded, replayed) in enumerate(pairs):
        np.testing.assert_array_equal(recorded, po["out"][k])
        np.testing.assert_array_equal(replayed, po["out"][k])


def test_port_api_dump_reads_in_jax():
    """The port's API dump: the config, the init event at the first
    format-driven initialization (between the first render frame and the
    first capture frame), 12 render and 12 capture frames; the JAX reader
    decodes it to the port reader's events."""
    po = run.port_session()
    events = dp.read_dump(po["dump"])
    types = [e["type"] for e in events]
    assert types[:4] == [dp.CONFIG, dp.REVERSE_STREAM, dp.INIT, dp.STREAM]
    assert types.count(dp.INIT) == 1
    assert types.count(dp.REVERSE_STREAM) == types.count(dp.STREAM) == 12
    init = events[2]
    assert (init["sample_rate"], init["num_input_channels"],
            init["reverse_sample_rate"]) == (16000, 1, 16000)
    _assert_events_equal(events, j_dp.read_dump(po["dump"]))
    np.testing.assert_array_equal(events[1]["channels"][0],
                                  po["far"][0][:, 0])


def test_attach_after_the_first_frame_writes_config_then_init(tmp_path):
    """AttachAecDump with the format known writes the config and the init
    event at once; a runtime setting is recorded as it is applied, and
    detaching closes the file."""
    ap = api.AudioProcessing(run.config(cfg_mod), device="cpu")
    far, near = run.scene(2)
    run.run_frames(ap, [0], far, near)
    path = str(tmp_path / "late.aecdump")
    assert ap.attach_aec_dump(path) == api.kNoError
    ap.set_runtime_setting(api.RuntimeSetting.create_capture_post_gain(2.0))
    run.run_frames(ap, [1], far, near)
    assert ap.detach_aec_dump() == api.kNoError
    assert ap.detach_aec_dump() == api.kNoError
    events = aec_dump.load_dump(path)
    assert [e["type"] for e in events] == [
        dp.CONFIG, dp.INIT, dp.RUNTIME_SETTING, dp.REVERSE_STREAM,
        dp.STREAM]
    assert events[2]["capture_post_gain"] == pytest.approx(2.0)
    assert os.path.getsize(path) > 0
