"""The port's legacy int16 ``Resampler`` against the JAX package's, bit for
bit: every mode and case of tests/test_legacy_resampler.py (the reset and
push-length contract over the rate matrix, the channel-count errors, the
kernels and chains its goldens pin) on seeded int16 input, and the port's
tensor interface."""

import numpy as np
import pytest
import torch

from webrtc_audio_processing_tpu.ops import legacy_resampler as j_lr

from webrtc_audio_processing_tpu_torch.ops import legacy_resampler as lr

RATES = [8000, 16000, 32000, 44000, 48000, 96000]
PAIRS = [(a, b) for a in RATES for b in RATES]


def _noise(n, seed):
    return np.random.default_rng(seed).integers(-32768, 32768, n).astype(
        np.int16)


@pytest.mark.parametrize("ch", [1, 2])
def test_reset_matrix_matches(ch):
    rs, jrs = lr.Resampler(), j_lr.Resampler()
    for fin, fout in PAIRS:
        assert rs.reset(fin, fout, ch) == jrs.reset(fin, fout, ch), (fin, fout)


@pytest.mark.parametrize("ch", [0, 3, 8])
def test_bad_channel_counts_fail_alike(ch):
    assert lr.Resampler().reset(16000, 48000, ch) == -1
    assert j_lr.Resampler().reset(16000, 48000, ch) == -1


@pytest.mark.parametrize("fin,fout", PAIRS)
def test_push_matches_jax(fin, fout):
    """Three 10 ms frames of full-scale noise in mono and three in stereo
    through both Resamplers: the same return codes and lengths, and the
    same samples (the filter state carried across the frames)."""
    for ch in (1, 2):
        rs = lr.Resampler()
        jrs = j_lr.Resampler()
        rc = rs.reset_if_needed(fin, fout, ch)
        assert rc == jrs.reset_if_needed(fin, fout, ch)
        if rc:
            return
        for f in range(3):
            x = _noise(ch * fin // 100, 1000 * f + fin // 1000 + fout + ch)
            got, want = rs.push(x), jrs.push(x)
            assert got[0] == want[0] == 0
            assert len(got[1]) == ch * fout // 100
            np.testing.assert_array_equal(got[1], want[1])


def test_push_rejects_ragged_lengths_alike():
    for fin, fout, n in ((16000, 48000, 100), (48000, 16000, 470),
                         (8000, 48000, 70), (44000, 16000, 100)):
        rs, jrs = lr.Resampler(fin, fout, 1), j_lr.Resampler(fin, fout, 1)
        assert rs.push(_noise(n, n)) == (-1, None)
        assert jrs.push(_noise(n, n)) == (-1, None)


def test_reset_if_needed_keeps_state():
    rs = lr.Resampler(16000, 32000, 1)
    x = (np.sin(2 * np.pi * 440 / 16000 * np.arange(160)) * 10000).astype(
        np.int16)
    _, a = rs.push(x)
    assert rs.reset_if_needed(16000, 32000, 1) == 0
    _, b = rs.push(x)
    assert not np.array_equal(a, b)
    jrs = j_lr.Resampler(16000, 32000, 1)
    np.testing.assert_array_equal(jrs.push(x)[1], a)
    np.testing.assert_array_equal(jrs.push(x)[1], b)


# The chains and kernels the goldens of tests/test_legacy_resampler.py pin,
# and the rest of the 48 and 22 kHz families: (name, input block).
CHAINS = [("resample_48to16", 480), ("resample_16to48", 160),
          ("resample_48to8", 480), ("resample_8to48", 80),
          ("resample_22to16", 220), ("resample_16to22", 160),
          ("resample_22to8", 220), ("resample_8to22", 80)]


@pytest.mark.parametrize("name,block", CHAINS)
def test_chain_matches_jax(name, block):
    st, jst = lr._ChainState(), j_lr._ChainState()
    for f in range(3):
        x = _noise(block, f + block)
        np.testing.assert_array_equal(getattr(lr, name)(x, st),
                                      getattr(j_lr, name)(x, jst))
    assert vars(st) == vars(jst)


@pytest.mark.parametrize("name", ["upsample_by2", "downsample_by2"])
def test_by2_kernels_match_jax(name):
    state, jstate = [0] * 8, [0] * 8
    for f in range(3):
        x = _noise(160, 7 + f)
        np.testing.assert_array_equal(getattr(lr, name)(x, state),
                                      getattr(j_lr, name)(x, jstate))
    assert state == jstate


def test_goldens_of_the_reference_kernels():
    """tests/test_legacy_resampler.py's goldens from the C kernels."""
    from tests.test_legacy_resampler import G_16TO48_HEAD, G_48TO16_HEAD

    x = (np.sin(2 * np.pi * 1000 / 48000 * np.arange(960)) * 20000).astype(
        np.int16)
    st = lr._ChainState()
    out = np.concatenate([lr.resample_48to16(x[:480], st),
                          lr.resample_48to16(x[480:], st)])
    np.testing.assert_array_equal(out[:24], G_48TO16_HEAD)
    assert int(out.astype(np.int64).sum()) == 52974
    x = (np.sin(2 * np.pi * 1000 / 16000 * np.arange(320)) * 20000).astype(
        np.int16)
    st = lr._ChainState()
    out = np.concatenate([lr.resample_16to48(x[:160], st),
                          lr.resample_16to48(x[160:], st)])
    np.testing.assert_array_equal(out[:24], G_16TO48_HEAD)
    assert int(np.abs(out.astype(np.int64)).sum()) == 12016144


def test_tensor_in_tensor_out():
    x = _noise(320, 3)
    rc, out = lr.Resampler(32000, 16000, 1).push(torch.from_numpy(x))
    assert rc == 0 and isinstance(out, torch.Tensor)
    assert out.dtype == torch.int16 and out.shape == (160,)
    np.testing.assert_array_equal(
        out.numpy(), j_lr.Resampler(32000, 16000, 1).push(x)[1])


def test_stereo_channels_independent():
    rs = lr.Resampler(16000, 32000, 2)
    n = 320
    left = (np.sin(2 * np.pi * 500 / 16000 * np.arange(n)) * 12000).astype(
        np.int16)
    interleaved = np.zeros(2 * n, np.int16)
    interleaved[0::2] = left
    rc, out = rs.push(interleaved)
    assert rc == 0 and len(out) == 4 * n
    assert np.abs(out[1::2]).max() == 0
    assert np.abs(out[0::2]).max() > 8000

