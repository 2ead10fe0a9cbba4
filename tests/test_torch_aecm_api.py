"""The mobile echo canceller through the port's ``api.AudioProcessing`` and
``run_offline --aecm``, on the CPU.

The API in the reference's fixed profile (tests/torch_aecm_util.py) at
16 kHz mono against the JAX package's ``AudioProcessing`` over 30 frames of
an echo scene with ``set_stream_delay_ms(30)``, on the banded path
(``process_reverse_stream`` then ``process_stream``) with each one's AGC1
recommendation fed back: per frame relative RMS <= 1e-3 and the same
level. The first frames pass the near end through (AECM's startup), so
the scene checks that the reported delay reaches AECM: a different delay
leaves startup on another frame."""

import numpy as np
import pytest

import chip_smoke

from webrtc_audio_processing_tpu import api as j_api
from webrtc_audio_processing_tpu import config as j_cfg

from webrtc_audio_processing_tpu_torch import api, run_offline
from webrtc_audio_processing_tpu_torch import config as cfg_mod
from webrtc_audio_processing_tpu_torch.utils import wav_io

from tests.torch_aecm_util import RTOL_RMS, fixed_profile

N_FRAMES = 30
RATE = 16000
FRAME = RATE // 100
RMS_FLOOR = 1.0 / 32768.0  # one int16 step in [-1, 1]


def scene(seed=21):
    """tests/test_aecm_apm.py's speech-like far end, and the near end: its
    echo 30 ms late with tests/test_aecm.py's smear and a voiced talker at
    0.1 of full scale (chip_smoke.voiced_near_end), (n, 1) float32 each."""
    rng = np.random.default_rng(seed)
    n = N_FRAMES * FRAME
    tt = np.arange(n) / RATE
    burst = (np.sin(2 * np.pi * 2.7 * tt) > -0.3)
    level = 0.08 + 0.92 * np.abs(np.sin(2 * np.pi * 0.31 * tt))
    far = rng.normal(size=n) * 0.28 * burst * level
    fd = np.roll(far, 480 + FRAME)
    near = (0.5 * fd + 0.2 * np.roll(fd, 1) + 0.1 * np.roll(fd, 2)
            + chip_smoke.voiced_near_end(n, RATE, seed, 0.1))
    return (far[:, None].astype(np.float32), near[:, None].astype(np.float32))


def run(ap, far, near, delay_ms=30):
    out = {"out": [], "level": [], "err": []}
    level = 100
    for k in range(N_FRAMES):
        sl = slice(k * FRAME, (k + 1) * FRAME)
        ap.set_stream_analog_level(level)
        err, _ = ap.process_reverse_stream(far[sl], RATE)
        out["err"].append(err)
        assert ap.set_stream_delay_ms(delay_ms) == 0
        err, y = ap.process_stream(near[sl], RATE)
        out["err"].append(err)
        level = ap.recommended_stream_analog_level()
        out["out"].append(np.asarray(y))
        out["level"].append(level)
    out["stats"] = vars(ap.get_statistics())
    return out


@pytest.fixture(scope="module")
def runs():
    far, near = scene()
    return (run(j_api.AudioProcessing(fixed_profile(j_cfg)), far, near),
            run(api.AudioProcessing(fixed_profile(cfg_mod), device="cpu"),
                far, near))


def _rel_rms(got, want):
    err = np.sqrt(np.mean((got - want) ** 2))
    return err / max(np.sqrt(np.mean(want ** 2)), RMS_FLOOR)


@pytest.mark.parametrize("frame", range(0, N_FRAMES, 3))
def test_api_frame_matches_jax(runs, frame):
    want, got = runs
    for f in range(frame, frame + 3):
        assert _rel_rms(got["out"][f], want["out"][f]) <= RTOL_RMS, f
        assert got["level"][f] == want["level"][f], f
    assert set(got["err"]) == set(want["err"]) == {api.kNoError}


def test_api_statistics_match_jax(runs):
    """get_statistics() after the last frame; the run's output carried
    signal (the startup's pass-through, then the residual AECM leaves)."""
    assert np.sqrt(np.mean(np.concatenate(runs[0]["out"]) ** 2)) > 1e-3
    want, got = runs[0]["stats"], runs[1]["stats"]
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert (g is None) == (w is None), k
        if isinstance(w, float):
            assert abs(g - w) <= 1e-4 * max(abs(w), 1.0), k
        elif w is not None:
            assert g == w, k


def test_stream_delay_reaches_aecm(runs):
    """At 500 ms reported, startup lasts longer (its FIFO fills to the
    delay), so the output passes the near end through on frames the 30 ms
    run already processed."""
    far, near = scene()
    late = run(api.AudioProcessing(fixed_profile(cfg_mod), device="cpu"),
               far, near, delay_ms=500)
    got = runs[1]
    differ = [f for f in range(N_FRAMES)
              if not np.array_equal(late["out"][f], got["out"][f])]
    assert differ, "the reported delay changed nothing"


def test_run_offline_aecm_on_a_short_wav(tmp_path, capsys):
    """``run_offline --aecm`` on a 0.3 s WAV pair on the CPU: the mobile
    echo canceller runs, the output WAV has the input's length."""
    far, near = scene()
    n = 30 * FRAME
    wav_io.write_wav(str(tmp_path / "far.wav"), far[:n], RATE)
    wav_io.write_wav(str(tmp_path / "near.wav"), near[:n], RATE)
    rc = run_offline.main([str(tmp_path / "near.wav"),
                           str(tmp_path / "out.wav"), "--far",
                           str(tmp_path / "far.wav"), "--aecm",
                           "--stream-delay-ms", "30", "--device", "cpu"])
    assert rc == 0
    out, fs = wav_io.read_wav(str(tmp_path / "out.wav"))
    assert fs == RATE and np.asarray(out).reshape(-1).shape == (n,)
    assert np.isfinite(out).all()
    assert "processed 30 frames" in capsys.readouterr().out
