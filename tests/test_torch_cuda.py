"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs an NVIDIA GPU and nvcc and skips without them. On a
machine with a card (no JAX needed):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from webrtc_audio_processing_tpu_torch import apm, config as cfg_mod
from webrtc_audio_processing_tpu_torch.ops import (
    biquad,
    cuda_biquad,
    cuda_window,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card with -m cuda)")
    return torch.device("cuda")


@pytest.mark.parametrize("lanes", [1, 63, 4096])
@pytest.mark.parametrize("rate", [16000, 48000])
def test_k1_matches_twin_bit_for_bit(device, lanes, rate):
    rng = np.random.default_rng(lanes)
    coeffs = torch.from_numpy(biquad.pack_coeffs(*biquad.HPF_COEFFS[rate]))
    x = torch.from_numpy(
        (rng.standard_normal((480, lanes)) * 3000).astype(np.float32))
    st = torch.from_numpy(
        (rng.standard_normal((12, lanes)) * 1000).astype(np.float32))
    st_k, y_k = cuda_biquad.cascade(coeffs.to(device), st.to(device),
                                    x.to(device))
    st_p, y_p = cuda_biquad.cascade_plain(coeffs.to(device), st.to(device),
                                          x.to(device))
    torch.cuda.synchronize()
    assert torch.equal(y_k, y_p)
    assert torch.equal(st_k, st_p)
    # The twin gives the same bits on the CPU.
    st_c, y_c = cuda_biquad.cascade(coeffs, st, x)
    assert torch.equal(y_k.cpu(), y_c) and torch.equal(st_k.cpu(), st_c)


def test_k5_matches_twin_bit_for_bit(device):
    rng = np.random.default_rng(5)
    buf = torch.from_numpy(rng.standard_normal((2048, 864)).astype(np.float32))
    start = torch.from_numpy(rng.integers(-900, 900, 2048).astype(np.int32))
    got = cuda_window.take_windows(buf.to(device), start.to(device), 480)
    want = cuda_window.take_windows_plain(buf.to(device), start.to(device),
                                          480)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), cuda_window.take_windows(buf, start, 480))


def test_slice_runs_through_both_kernels(device):
    config = cfg_mod.Config().replace(
        pipeline=cfg_mod.Pipeline(multi_channel_capture=True,
                                  multi_channel_render=True,
                                  maximum_internal_processing_rate=48000),
        high_pass_filter=cfg_mod.HighPassFilter(enabled=True),
        noise_suppression=cfg_mod.NoiseSuppression(enabled=True),
        gain_controller2=cfg_mod.GainController2(
            enabled=True,
            adaptive_digital=cfg_mod.AdaptiveDigital(enabled=True)),
    )
    geo = apm.ApmGeometry.create(config, 48000, 2, num_render_channels=2)
    state = apm.init_state(geo, 8, device)
    rng = np.random.default_rng(0)
    k1, k5 = cuda_biquad.launches, cuda_window.launches
    for _ in range(3):
        x = torch.from_numpy(rng.uniform(-0.3, 0.3, (8, 480, 2)).astype(
            np.float32)).to(device)
        state, out, rout, _ = apm.process_stream_pair(geo, state, x, x)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and out.shape == (8, 480, 2)
    assert cuda_biquad.launches - k1 == 3
    assert cuda_window.launches - k5 == 3
