"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs an NVIDIA GPU and nvcc and skips without them. On a
machine with a card (no JAX needed):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke

from tests import torch_rate_matrix as matrix
from webrtc_audio_processing_tpu_torch import apm, config as cfg_mod
from webrtc_audio_processing_tpu_torch import step_graph
from webrtc_audio_processing_tpu_torch.models import post_filter
from webrtc_audio_processing_tpu_torch.models.aec3 import render_buffer
from webrtc_audio_processing_tpu_torch.ops import (
    biquad,
    cuda_biquad,
    cuda_matched_filter,
    cuda_pre_echo,
    cuda_span,
    cuda_subtractor,
    cuda_window,
    qmf,
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


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("B,L,W", [(2048, 864, 480), (13, 864, 480),
                                   (13, 863, 479)])
def test_k5_matches_twin_bit_for_bit(device, B, L, W, dtype):
    """Starts of every residue mod 4 (the shift within a 16-byte line),
    negative and past L - W, as int32 and int64; B not a multiple of the 8
    rows per block; a row and width off the 16-byte grid (the per-float
    copy)."""
    rng = np.random.default_rng(B + L)
    buf = torch.from_numpy(rng.standard_normal((B, L)).astype(np.float32))
    start = rng.integers(-900, 900, B)
    start[:8] = (0, 1, 2, 3, L - W - 1, L - W, -1, -L - 5)
    start = torch.from_numpy(start.astype(dtype))
    got = cuda_window.take_windows(buf.to(device), start.to(device), W)
    want = cuda_window.take_windows_plain(buf.to(device), start.to(device),
                                          W)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), cuda_window.take_windows(buf, start, W))


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


def _random_table(rng, K):
    """K stable sections; every other section has b0 = b2 = 1, as the
    port's tables do after their first."""
    poles = rng.uniform(0.5, 0.95, K)
    b = np.stack([rng.uniform(0.2, 1.2, K), -rng.uniform(0.2, 1.5, K),
                  rng.uniform(0.2, 1.2, K)], 1)
    b[1::2, 0] = b[1::2, 2] = 1.0
    a = np.stack([-2 * poles * 0.9, poles ** 2], 1)
    return biquad.pack_coeffs(b, a)


@pytest.mark.parametrize("T,M", [(1, 63), (3, 4100), (50, 63), (480, 4100)])
@pytest.mark.parametrize("K", [1, 2, 3, 4, 5])
def test_k1_skew_fill_and_drain_match_twin(device, K, T, M):
    """The skewed cascade's fill and drain: T below K, T not a multiple of
    the 32-sample chunk, M not a multiple of the 32-lane block."""
    rng = np.random.default_rng(100 * K + T)
    c = torch.from_numpy(_random_table(rng, K)).to(device)
    x = torch.from_numpy(
        (rng.standard_normal((T, M)) * 3000).astype(np.float32)).to(device)
    st = torch.from_numpy(
        (rng.standard_normal((4 * K, M)) * 1000).astype(np.float32)).to(device)
    st_k, y_k = cuda_biquad.cascade(c, st, x)
    st_p, y_p = cuda_biquad.cascade_plain(c, st, x)
    torch.cuda.synchronize()
    assert torch.equal(y_k, y_p) and torch.equal(st_k, st_p)


def _decimator_table():
    aa, nr = render_buffer.decimator_coeffs()
    return np.concatenate([aa, nr])


@pytest.mark.parametrize("table", ["decimator", "post_filter", "qmf_1",
                                   "qmf_2", "decimator_ds8"])
def test_k1_new_callers_match_twin_bit_for_bit(device, table):
    """K1 at the AEC3 decimators' shape (4 sections, one signal per stream,
    T = 64), the PostFilter's (4 sections, 2 channels, T = 480) and the
    QMF's (3 first-order all-pass rows in the all-pass form, T = 160, M off
    the 32-lane block)."""
    coeffs, T, M = {
        "decimator": (_decimator_table(), 64, 2048),
        "post_filter": (biquad.pack_coeffs(post_filter.COEFFS_B_48K,
                                           post_filter.COEFFS_A_48K),
                        480, 4096),
        "qmf_1": (qmf.allpass_rows(qmf.ALLPASS_COEF_1), 160, 4096),
        "qmf_2": (qmf.allpass_rows(qmf.ALLPASS_COEF_2), 160, 8192 + 5),
        # The factor-8 decimators: five band-pass sections, M = B = 4096.
        "decimator_ds8": (render_buffer.decimator_coeffs(8)[0], 64, 4096),
    }[table]
    K = coeffs.shape[0]
    rng = np.random.default_rng(11)
    c = torch.from_numpy(coeffs).to(device)
    x = torch.from_numpy(
        (rng.standard_normal((T, M)) * 3000).astype(np.float32)).to(device)
    st = torch.from_numpy(
        (rng.standard_normal((4 * K, M)) * 100).astype(np.float32)).to(
            device)
    allpass = table.startswith("qmf")
    st_k, y_k = cuda_biquad.cascade(c, st, x, allpass)
    st_p, y_p = cuda_biquad.cascade_plain(c, st, x, allpass)
    torch.cuda.synchronize()
    assert torch.equal(y_k, y_p) and torch.equal(st_k, st_p)


@pytest.mark.parametrize("F,W", [(512, 19), (384, 15), (6, 3), (256, 17),
                                 (128, 13)])
def test_k2_matches_twin_bit_for_bit(device, F, W):
    rng = np.random.default_rng(F)
    ring = torch.from_numpy(
        rng.standard_normal((2048, 200, F)).astype(np.float32)).to(device)
    start = torch.from_numpy(
        rng.integers(-250, 250, 2048).astype(np.int32)).to(device)
    got = cuda_span.span_gather(ring, start, W)
    want = cuda_span.span_gather_plain(ring, start, W)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _max_rel(a, b):
    a = a.double()
    return float((a - b.double()).abs().max() / (a.abs().max() + 1e-30))


def _k3_inputs(B, taps, sub, seed):
    """Inputs of K3 at the matched filter's ring (DS = 2448, 5 filters 384
    apart, tests/test_pallas_mf_kernel.py's scales), every x^2 far from
    the threshold taps * 150^2 (x^2 ~ taps * 400^2)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    low = rng.standard_normal((B, 2448)).astype(f) * 400
    lr = rng.integers(0, 2448, B).astype(np.int32)
    h0 = rng.standard_normal((B, 5, taps)).astype(f) * 0.01
    y = rng.standard_normal((B, sub)).astype(f) * 400
    sm = np.full((B,), 0.7, f)
    return low, lr, h0, y, sm


def _k3_check(device, low, lr, h0, y, sm):
    """Max-relative 2e-5 on h, alphas and err; updated and segs exact
    (tests/test_pallas_mf_kernel.py's bar). Returns the kernel's output."""
    taps = h0.shape[-1]
    args = [torch.from_numpy(a).to(device) for a in (low, lr, h0, y, sm)]
    kw = dict(shift=384, ds_size=2448, threshold=taps * 150.0 ** 2)
    got = cuda_matched_filter.nlms(*args, **kw)
    want = cuda_matched_filter.nlms_plain(*args, **kw)
    torch.cuda.synchronize()
    for name, g, w in zip(("h", "alphas", "err"), got[:3], want[:3]):
        assert _max_rel(w, g) <= 2e-5, name
    assert torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])
    return got


@pytest.mark.parametrize("B", [3, 2048])
@pytest.mark.parametrize("taps,sub", [(512, 16), (384, 16), (256, 8),
                                      (128, 1)])
def test_k3_matches_twin(device, taps, sub, B):
    """The specialised form (taps 512, sub 16) and the runtime-sub form."""
    _k3_check(device, *_k3_inputs(B, taps, sub, seed=B + taps + sub))


@pytest.mark.parametrize("taps,sub", [(512, 16), (256, 8)])
def test_k3_segment_wraps_the_ring_end(device, taps, sub):
    """Read indices whose filters' segments run past DS and wrap to 0."""
    low, lr, h0, y, sm = _k3_inputs(6, taps, sub, seed=11)
    seg_len = sub - 1 + taps
    lr[:] = [2448 - 1, 2448 - seg_len // 2, 2448 - seg_len + 1,
             2448 - 384 - 5, 2448 - 4 * 384 - 1, 0]
    got = _k3_check(device, low, lr, h0, y, sm)
    segs = got[4].cpu().numpy()
    assert np.array_equal(segs[0, 0, 1:4], low[0, :3])  # wrapped


def test_k3_saturated_capture_sample_closes_its_step(device):
    """|y_i| >= 32000 gates step i shut on every filter: its alphas are 0."""
    low, lr, h0, y, sm = _k3_inputs(5, 512, 16, seed=12)
    y[1, 3], y[2, 0], y[4, 15] = 32000.0, -32001.0, 40000.0
    got = _k3_check(device, low, lr, h0, y, sm)
    alphas = got[1].cpu()
    assert (alphas[1, :, 3] == 0).all() and (alphas[2, :, 0] == 0).all()
    assert (alphas[4, :, 15] == 0).all() and (alphas[0] != 0).all()


def test_k3_stream_below_the_threshold_is_not_updated(device):
    """A stream whose render is 100x quieter has x^2 below the threshold on
    every window: no filter of it updates and its alphas are 0."""
    low, lr, h0, y, sm = _k3_inputs(4, 512, 16, seed=13)
    low[2] *= 0.01
    got = _k3_check(device, low, lr, h0, y, sm)
    updated, alphas = got[3].cpu(), got[1].cpu()
    assert not updated[2].any() and (alphas[2] == 0).all()
    assert updated[[0, 1, 3]].all()
    assert torch.equal(got[0][2].cpu(), torch.from_numpy(h0[2]))


@pytest.mark.parametrize("B", [3, 2047, 2048])
@pytest.mark.parametrize("taps,acc_rate", [(512, 4), (256, 8), (1024, 1)])
def test_k4_matches_twin(device, taps, acc_rate, B):
    """Within 2e-4 after dividing by max(|out|, 1)
    (tests/test_pallas_pre_echo.py's bar): the specialised form (taps 512,
    acc_rate 4; B = 2047 leaves the last block of four streams ragged) and
    the general form."""
    rng = np.random.default_rng(B + taps + acc_rate)
    f = np.float32
    seg = torch.from_numpy(rng.standard_normal((B, taps + 15)).astype(f))
    h0 = torch.from_numpy((rng.standard_normal((B, taps)) * 0.1).astype(f))
    al = torch.from_numpy((rng.standard_normal((B, 16)) * 0.01).astype(f))
    y = torch.from_numpy(rng.standard_normal((B, 16)).astype(f))
    args = [t.to(device) for t in (seg, h0, al, y)]
    got = cuda_pre_echo.pre_echo_inst(*args, acc_rate)
    want = cuda_pre_echo.pre_echo_plain(*args, acc_rate)
    torch.cuda.synchronize()
    assert got.shape == (B, taps // acc_rate)
    scale = torch.clamp(want.abs(), min=1.0)
    assert float(((got - want) / scale).abs().max()) <= 2e-4


def test_aec3_path_runs_through_every_kernel(device):
    """The 48 kHz stereo AEC3 path launches K1 14 times, K2 8, K3 and K4
    5 each and K5 twice per frame pair."""
    config = cfg_mod.Config().replace(
        pipeline=cfg_mod.Pipeline(multi_channel_capture=True,
                                  multi_channel_render=True,
                                  maximum_internal_processing_rate=48000),
        high_pass_filter=cfg_mod.HighPassFilter(enabled=True),
        echo_canceller=cfg_mod.EchoCanceller(enabled=True),
        noise_suppression=cfg_mod.NoiseSuppression(enabled=True),
        gain_controller2=cfg_mod.GainController2(
            enabled=True,
            adaptive_digital=cfg_mod.AdaptiveDigital(enabled=True)),
    )
    geo = apm.ApmGeometry.create(config, 48000, 2, num_render_channels=2,
                                 aec3_stereo_content=True)
    state = apm.init_state(geo, 8)
    rng = np.random.default_rng(0)
    mods = (cuda_biquad, cuda_span, cuda_matched_filter, cuda_pre_echo,
            cuda_window)
    before = [m.launches for m in mods]
    for _ in range(4):
        x = torch.from_numpy(rng.uniform(-0.3, 0.3, (8, 480, 2)).astype(
            np.float32)).to(device)
        state, out, rout, stats = apm.process_stream_pair(geo, state, x, x)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and out.shape == (8, 480, 2)
    assert [m.launches - b for m, b in zip(mods, before)] == [28, 16, 10, 10,
                                                             4]


@pytest.mark.parametrize("C,R,nb,events,jumps", [
    (C, R, nb, events, False) for C, R in [(2, 2), (1, 1)] for nb in [2, 3]
    for events in [False, True]] + [(2, 2, 3, False, True),
                                    (1, 1, 2, False, True)])
def test_k6_matches_twin(device, C, R, nb, events, jumps):
    """K6 at the 48 kHz stereo (C = R = 2, P = 13, Pc = 11) and 16 kHz mono
    (C = R = 1, P = Pc = 13) geometries: float leaves within 2e-3 of their
    scale (tests/test_subtractor_pallas.py's bar), integer leaves exact
    (with chip_smoke.k6_compare's rule for refined/coarse ties). With
    ``jumps``, window starts that jump to the second chain or clamp at
    either end of it, which the kernel loads block by block."""
    _check_k6(device, C, R, nb, events, below_gate=False, jumps=jumps)


@pytest.mark.parametrize("nb", [2, 3])
@pytest.mark.parametrize("C,R", [(2, 2), (1, 1)])
def test_k6_matches_twin_below_the_noise_gate(device, C, R, nb):
    """The same with render spectra below the gains' noise gate, where
    refined and coarse error energies tie to ulps after a coarse reset and
    the tie rule decides which integer differences are rounding."""
    _check_k6(device, C, R, nb, False, below_gate=True)


def _check_k6(device, C, R, nb, events, below_gate, jumps=False):
    inp = chip_smoke.k6_inputs(256, C, R, nb, events, seed=nb + 2 * C,
                               device=device, below_gate=below_gate,
                               jumps=jumps)
    before = cuda_subtractor.launches
    got = cuda_subtractor.pair(*inp.values())
    want = cuda_subtractor.pair_plain(*chip_smoke.k6_clamped(inp).values())
    torch.cuda.synchronize()
    rel, _, unequal, _ = chip_smoke.k6_compare(got, want)
    assert rel <= chip_smoke.K6_RTOL and not unequal, (rel, unequal)
    assert cuda_subtractor.launches - before == 1


@pytest.mark.parametrize("mode", ["48k_stereo", "16k_mono"])
def test_pair_kernel_path_launches_k6_once_per_frame(device, mode):
    geo = chip_smoke.aec3_geometry(mode, pair_kernel=True)
    rate, channels, _ = chip_smoke.BENCH_MODES[mode]
    state = apm.init_state(geo, 8, device)
    rng = np.random.default_rng(1)
    before = cuda_subtractor.launches
    for _ in range(4):
        x = torch.from_numpy(rng.uniform(-0.3, 0.3, (
            8, rate // 100, channels)).astype(np.float32)).to(device)
        state, out, _, _ = apm.process_stream_pair(geo, state, x, x)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert cuda_subtractor.launches - before == 4


def _leaves(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in _leaves(o)]


def _k6_call(device):
    inp = chip_smoke.k6_inputs(64, 2, 2, 3, True, seed=7, device=device)
    config, _, *args = inp.values()
    return lambda: cuda_subtractor.pair_cuda(config, *args)


def _kernel_calls(device):
    """One wrapper call per kernel at a small shape, on fixed inputs."""
    rng = np.random.default_rng(9)

    def t(shape, scale=1.0, dtype=np.float32):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(dtype)).to(device)

    coeffs = torch.from_numpy(_decimator_table()).to(device)
    x, st = t((64, 100), 3000), t((16, 100), 100)
    buf, starts = t((13, 864)), torch.from_numpy(
        rng.integers(-900, 900, 13)).to(device)
    ring, span_start = t((9, 200, 384)), torch.from_numpy(
        rng.integers(0, 186, 9).astype(np.int32)).to(device)
    low = t((3, 2448), 400)
    lr = torch.from_numpy(rng.integers(0, 2448, 3).astype(np.int32)).to(
        device)
    h0, y, sm = t((3, 5, 512), 0.01), t((3, 16), 400), torch.full(
        (3,), 0.7, device=device)
    kw = dict(shift=384, ds_size=2448, threshold=512 * 150.0 ** 2)
    seg, al = t((3, 527)), t((3, 16), 0.01)
    low8, h8 = t((3, 2448), 400), t((3, 5, 256), 0.01)
    seg8, h4 = t((3, 271)), t((3, 256), 0.1)
    return {
        "K1": lambda: cuda_biquad.cascade_cuda(coeffs, st, x),
        "K2": lambda: cuda_span.span_gather_cuda(ring, span_start, 15),
        "K3": lambda: cuda_matched_filter.nlms_cuda(low, lr, h0, y, sm, **kw),
        "K4": lambda: cuda_pre_echo.pre_echo_cuda(seg, h0[:, 0].contiguous(),
                                                  al, y, 4),
        "K3_general": lambda: cuda_matched_filter.nlms_cuda(
            low8, lr, h8, y[:, :8].contiguous(), sm, **kw),
        "K4_general": lambda: cuda_pre_echo.pre_echo_cuda(seg8, h4, al, y, 8),
        "K5": lambda: cuda_window.take_windows_cuda(buf, starts, 480),
        "K6": _k6_call(device),
    }


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K3_general", "K4",
                                    "K4_general", "K5", "K6"])
def test_graph_replay_matches_eager_launch(device, kernel):
    """chip_smoke.py times each kernel's device work by replaying captured
    calls: a captured call must launch the same work. No wrapper syncs
    with the host, or the capture fails."""
    fn = _kernel_calls(device)[kernel]
    eager = _leaves(fn())
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = _leaves(fn())
    graph.replay()
    torch.cuda.synchronize()
    assert len(eager) == len(captured)
    for e, c in zip(eager, captured):
        assert torch.equal(e, c)


@pytest.mark.parametrize("mode,pair_kernel", [("48k_stereo", False),
                                              ("48k_stereo", True),
                                              ("16k_mono", True),
                                              ("default_48k", False)])
def test_pair_graph_replays_equal_eager_pair_steps(device, mode,
                                                   pair_kernel):
    """The pair step captured as one CUDA graph and replayed for 40 pairs
    (200 blocks, past the 48 kHz stereo ring's wrap at L = 167) at B = 4,
    against the same pairs run eagerly from an equal state: every output,
    every delay and, at the end, every state leaf bit for bit, the block
    ordinal included."""
    geo = chip_smoke.aec3_geometry(mode, pair_kernel)
    rate, channels, _ = chip_smoke.MODES[mode]
    frame = rate // 100
    render, capture = chip_smoke.echo_scene(80, 5, range(4), rate, channels)
    ren = torch.from_numpy(render).to(device)
    cap = torch.from_numpy(capture).to(device)
    graph = step_graph.PairGraph(geo, apm.init_state(geo, 4, device))
    graph.capture()
    eager = apm.init_state(geo, 4, device)
    for p in range(40):
        args = []
        for f in (2 * p, 2 * p + 1):
            sl = slice(f * frame, (f + 1) * frame)
            args += [ren[:, sl], cap[:, sl]]
        got = graph.replay(*args)
        want = step_graph.step_pair(geo, eager, *args)
        for (g, g_r, g_st), (w, w_r, w_st) in zip(got, want):
            assert torch.equal(g, w) and torch.equal(g_r, w_r), p
            assert torch.equal(g_st["delay_ms"], w_st["delay_ms"]), p
    assert graph.state.frame_counter == eager.frame_counter == 80
    got, want = apm.state_to_numpy(graph.state), apm.state_to_numpy(eager)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert int(graph.state.aec3_block_ordinal) == 200


def test_pair_graph_refuses_an_odd_frame(device):
    geo = chip_smoke.aec3_geometry("16k_mono", pair_kernel=False)
    state = apm.init_state(geo, 2, device)
    state.frame_counter = 1
    with pytest.raises(ValueError, match="even frame"):
        step_graph.PairGraph(geo, state)
    state.frame_counter = 0
    graph = step_graph.PairGraph(geo, state)
    state.frame_counter = 3
    with pytest.raises(ValueError, match="even frame"):
        graph.capture()


@pytest.mark.parametrize("case", sorted(matrix.CASES))
def test_rate_matrix_case_on_the_card_matches_the_cpu(device, case):
    """Each case of the rate and channel matrix (tests/torch_rate_matrix.py)
    for 6 frames at B = 4 on the card: every kernel launched as often as
    ``chip_smoke.expected_aec3_launches`` says (K1 on the QMF where the
    processing rate is 32 kHz); then the last frame once more on the CPU
    from the card's state before it: relative RMS <= 1e-3 per stream, the
    same delay, outputs of the API's shapes."""
    rate, cap, ren, _ = matrix.CASES[case]
    geo = matrix.geometry(apm, cfg_mod, case)
    renders, captures = matrix.scene(case, 6, 4, seed=9)
    state = apm.init_state(geo, 4, device)
    chip_smoke._reset_counts()
    for f in range(5):
        state, _, _, _ = apm.process_stream_pair(
            geo, state, torch.from_numpy(captures[f]).to(device),
            torch.from_numpy(renders[f]).to(device))
    cpu_state = chip_smoke.select_streams(
        state, torch.arange(4, device=device), "cpu")
    state, out, rout, stats = apm.process_stream_pair(
        geo, state, torch.from_numpy(captures[5]).to(device),
        torch.from_numpy(renders[5]).to(device))
    torch.cuda.synchronize()
    assert chip_smoke._counts() == chip_smoke.expected_aec3_launches(geo, 6)
    _, c_out, c_rout, c_stats = apm.process_stream_pair(
        geo, cpu_state, torch.from_numpy(captures[5]),
        torch.from_numpy(renders[5]))
    assert out.shape == (4, rate // 100, cap)
    assert rout.shape == (4, rate // 100, ren)
    for got, want in ((out, c_out), (rout, c_rout)):
        got, want = got.cpu().numpy(), want.numpy()
        assert np.isfinite(got).all()
        rel = np.sqrt(((got - want) ** 2).sum(axis=(1, 2))
                      / np.maximum((want ** 2).sum(axis=(1, 2)), 1e-30))
        assert (rel <= 1e-3).all(), rel
    np.testing.assert_array_equal(stats["delay_ms"].cpu().numpy(),
                                  c_stats["delay_ms"].numpy())


# ------------------------------------------- the API and the engine


@pytest.mark.parametrize("mode", ["default_48k", "48k_stereo"])
def test_frame_graphs_replay_equal_eager_frames(device, mode):
    """The one-frame step captured as two graphs (even and odd frame) and
    replayed alternately for 80 frames (200 blocks, past the 48 kHz stereo
    ring's wrap at L = 167) at B = 4, against the same frames run eagerly:
    every output and delay of both parities and, at the end, every state
    leaf bit for bit, the block ordinal included."""
    geo = chip_smoke.aec3_geometry(mode, False)
    rate, channels, _ = chip_smoke.MODES[mode]
    frame = rate // 100
    render, capture = chip_smoke.echo_scene(80, 6, range(4), rate, channels)
    ren = torch.from_numpy(render).to(device)
    cap = torch.from_numpy(capture).to(device)
    graphs = step_graph.FrameGraphs(geo, apm.init_state(geo, 4, device))
    graphs.capture_graphs()
    eager = apm.init_state(geo, 4, device)
    for f in range(80):
        sl = slice(f * frame, (f + 1) * frame)
        g, g_r, g_st = graphs.replay(cap[:, sl], ren[:, sl])
        eager, w, w_r, w_st = apm.process_stream_pair(geo, eager, cap[:, sl],
                                                      ren[:, sl])
        assert torch.equal(g, w) and torch.equal(g_r, w_r), f
        assert torch.equal(g_st["delay_ms"], w_st["delay_ms"]), f
    assert graphs.state.frame_counter == eager.frame_counter == 80
    got, want = apm.state_to_numpy(graphs.state), apm.state_to_numpy(eager)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert int(graphs.state.aec3_block_ordinal) == 200


def test_api_on_the_card_matches_process_stream_pair(device):
    """``api.AudioProcessing`` (reverse, then capture) on ``Config()``'s
    pipeline at 48 kHz stereo against ``apm.process_stream_pair`` at B = 1
    on the same frames: bit for bit, delays equal, K1-K5 launched as
    ``expected_aec3_launches`` says."""
    from webrtc_audio_processing_tpu_torch import api

    n = 30
    render, capture = chip_smoke.echo_scene(n, 7, [0], 48000, 2)
    ap = api.AudioProcessing(chip_smoke.aec3_config(cfg_mod, "default_48k"),
                             device=device)
    chip_smoke._reset_counts()
    outs, delays = [], []
    for f in range(n):
        sl = slice(f * 480, (f + 1) * 480)
        assert ap.process_reverse_stream(render[0, sl], 48000)[0] == 0
        err, out = ap.process_stream(capture[0, sl], 48000)
        assert err == 0
        outs.append(out)
        delays.append(ap.get_statistics().delay_ms)
    assert chip_smoke._counts() == chip_smoke.expected_aec3_launches(
        ap._geo, n)
    direct, direct_delays = chip_smoke.api_direct_outputs(
        ap._geo, device, render[0], capture[0], n)
    np.testing.assert_array_equal(np.stack(outs), direct)
    assert delays == direct_delays


def test_engine_on_frame_graphs_matches_eager_steps_with_missed_frames(
        device):
    """``BatchEngine`` on ``runtime.apm_step_fn``'s graphs at B = 256 of
    ``default_48k``, two steps a flush: every 8th stream misses every 5th
    frame; each stream's popped outputs are its rows of eager
    ``process_stream_pair`` steps fed zeros there, bit for bit."""
    from webrtc_audio_processing_tpu_torch.runtime import (
        BatchEngine,
        StreamingPlane,
        apm_step_fn,
    )

    B, n = 256, 20
    geo = chip_smoke.aec3_geometry("default_48k", False)
    render, capture = chip_smoke.echo_scene(n, 8, range(B), 48000, 2)
    step_fn, state, graphs = apm_step_fn(geo, B, device)
    assert graphs is not None
    plane = StreamingPlane(B, 480, 2, 2, queue_capacity=n)
    engine = BatchEngine(plane, step_fn, state, flush_every=2, device=device)
    eager = apm.init_state(geo, B, device)
    miss = np.arange(B) % 8 == 0
    rows = torch.from_numpy(miss).to(device)[:, None, None]
    want = {s: [] for s in range(B)}
    for f in range(n):
        missed = f % 5 == 0
        sl = slice(f * 480, (f + 1) * 480)
        for s in range(B):
            if not (missed and miss[s]):
                assert plane.push_capture(s, capture[s, sl])
                assert plane.push_render(s, render[s, sl])
        engine.step()
        cap = torch.from_numpy(capture[:, sl]).to(device)
        ren = torch.from_numpy(render[:, sl]).to(device)
        if missed:
            cap, ren = torch.where(rows, 0.0, cap), torch.where(rows, 0.0, ren)
        eager, out, _, _ = apm.process_stream_pair(geo, eager, cap, ren)
        out = out.cpu().numpy()
        for s in range(B):
            if not (missed and miss[s]):
                want[s].append(out[s])
    engine.flush()
    for s in range(B):
        got = [plane.pop_output(s) for _ in range(len(want[s]))]
        assert plane.pop_output(s) is None
        np.testing.assert_array_equal(np.stack(got), np.stack(want[s]),
                                      err_msg=str(s))
        assert plane.frames_processed(s) == len(want[s])
        assert plane.dropped(s) == 0


def test_streaming_plane_builds_into_the_build_directory(device):
    from webrtc_audio_processing_tpu_torch.ops import cuda_build
    from webrtc_audio_processing_tpu_torch.runtime import streaming

    path = streaming._build_library()
    assert path.parent == cuda_build.BUILD_DIR and path.exists()


# ------------------------------------------------------------------ AGC1


def _agc1_16k_geometry(hybrid=True, mode=cfg_mod.Agc1Mode.ADAPTIVE_ANALOG):
    """16 kHz mono with HPF, AEC3, NS and AGC1 (the hybrid manager unless
    ``hybrid`` is false)."""
    return apm.ApmGeometry.create(cfg_mod.Config().replace(
        high_pass_filter=cfg_mod.HighPassFilter(enabled=True),
        echo_canceller=cfg_mod.EchoCanceller(enabled=True),
        noise_suppression=cfg_mod.NoiseSuppression(enabled=True),
        gain_controller1=cfg_mod.GainController1(
            enabled=True, mode=mode,
            analog_gain_controller=cfg_mod.AnalogGainController(
                enabled=hybrid))), 16000, 1)


def _agc1_scene(n_frames, batch, seed):
    render, capture = chip_smoke.echo_scene(n_frames, seed, range(batch),
                                            16000, 1)
    capture[1::2, :, 0] += chip_smoke.voiced_near_end(capture.shape[1],
                                                      16000, seed)
    return render, capture


def _eager_to(geo, state, ren, cap, frames, volume):
    """``frames`` (even) eager frames of the scene on ``state`` in pairs,
    the volume taking frame 1's recommendation between pairs."""
    for p in range(frames // 2):
        args = []
        for f in (2 * p, 2 * p + 1):
            sl = slice(f * 160, (f + 1) * 160)
            args += [ren[:, sl], cap[:, sl]]
        outs = step_graph.step_pair(geo, state, *args, volume=volume)
        volume.copy_(outs[1][2]["agc1_recommended_level"])


@pytest.mark.parametrize("start", [0, 2, 4])
def test_pair_graph_at_period_6_equals_eager(device, start):
    """The hybrid AGC's cadence: three pair graphs, built from a state at
    frame ``start`` (each graph must replay at the phase it was captured
    at), replayed in turn for 30 pairs at B = 4, the volume taking each
    pair's last recommendation on the device between replays, against the
    same pairs run eagerly: outputs, levels, delays and at the end every
    state leaf bit for bit."""
    geo = _agc1_16k_geometry()
    n_pairs = 30
    render, capture = _agc1_scene(start + 2 * n_pairs, 4, 11)
    ren = torch.from_numpy(render).to(device)
    cap = torch.from_numpy(capture).to(device)
    volume = torch.full((4,), 100, dtype=torch.int32, device=device)
    eager = apm.init_state(geo, 4, device)
    _eager_to(geo, eager, ren, cap, start, volume)
    graph = step_graph.PairGraph(geo, copy.deepcopy(eager))
    graph.volume.copy_(volume)
    graph.capture()
    assert sorted(graph.graphs) == [0, 2, 4]
    for p in range(start // 2, start // 2 + n_pairs):
        args = []
        for f in (2 * p, 2 * p + 1):
            sl = slice(f * 160, (f + 1) * 160)
            args += [ren[:, sl], cap[:, sl]]
        got = graph.replay(*args)
        graph.volume.copy_(got[1][2]["agc1_recommended_level"])
        want = step_graph.step_pair(geo, eager, *args, volume=volume)
        volume.copy_(want[1][2]["agc1_recommended_level"])
        for (g, _, g_st), (w, _, w_st) in zip(got, want):
            assert torch.equal(g, w), p
            for k in ("delay_ms", "agc1_recommended_level"):
                assert torch.equal(g_st[k], w_st[k]), (p, k)
    assert torch.equal(graph.volume, volume)
    got, want = apm.state_to_numpy(graph.state), apm.state_to_numpy(eager)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.mark.parametrize("start", [0, 2])
def test_frame_graphs_at_period_6_equal_eager(device, start):
    """The one-frame step as six graphs at the hybrid AGC's period, built
    from a state at frame ``start``, replayed in turn for 36 frames at
    B = 4 with a volume input, against eager frames: outputs, levels and
    every state leaf bit for bit."""
    geo = _agc1_16k_geometry()
    render, capture = _agc1_scene(start + 36, 4, 12)
    ren = torch.from_numpy(render).to(device)
    cap = torch.from_numpy(capture).to(device)
    volume = torch.full((4,), 120, dtype=torch.int32, device=device)
    eager = apm.init_state(geo, 4, device)
    _eager_to(geo, eager, ren, cap, start, volume.clone())
    graphs = step_graph.FrameGraphs(geo, copy.deepcopy(eager))
    graphs.volume.copy_(volume)
    graphs.capture_graphs()
    assert sorted(graphs.graphs) == list(range(6))
    for f in range(start, start + 36):
        sl = slice(f * 160, (f + 1) * 160)
        g, _, g_st = graphs.replay(cap[:, sl], ren[:, sl])
        eager, w, _, w_st = apm.process_stream_pair(
            geo, eager, cap[:, sl], ren[:, sl], applied_input_volume=volume)
        assert torch.equal(g, w), f
        assert torch.equal(g_st["agc1_recommended_level"],
                           w_st["agc1_recommended_level"]), f
    got, want = apm.state_to_numpy(graphs.state), apm.state_to_numpy(eager)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.mark.parametrize("rows", [1, 33, 4096])
def test_agc1_limiter_matches_twin(device, rows):
    """The limiter kernel against its twin: gains of the worst case over
    AGC1's range and of random tables, envelopes up to full scale, int32's
    extremes among them."""
    from webrtc_audio_processing_tpu_torch.models.agc1 import digital
    from webrtc_audio_processing_tpu_torch.ops import cuda_agc1_limiter

    rng = np.random.default_rng(rows)
    table = digital.calculate_gain_table(40, 3, True, 20)
    gains = rng.choice(table, (rows, 11)).astype(np.int64)
    env = rng.integers(0, 2**30, (rows, 10))
    gains[::3, 1:] = int(digital.calculate_gain_table(90, 0, True, 90).max())
    env[::3] = 2**25 - 1
    gains[1::7, 3] = 2**31 - 1
    env[1::7, 2] = 2**30
    gains = torch.from_numpy(gains.astype(np.int32))
    env = torch.from_numpy(env.astype(np.int32))
    before = cuda_agc1_limiter.launches
    got = cuda_agc1_limiter.limit(gains.to(device), env.to(device))
    assert cuda_agc1_limiter.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  cuda_agc1_limiter.limit(gains, env).numpy())


def test_spl_on_the_card_equals_the_cpu(device):
    """The SPL primitives on int32's extremes and random values, and the
    downsampler's recurrence, the same bits on the card as on the CPU
    (shift counts and wrapping products included)."""
    from webrtc_audio_processing_tpu_torch.ops import spl

    rng = np.random.default_rng(3)
    edge = [-2**31, 2**31 - 1, 0, 1, -1, 2**30, 32767, -32768]
    x = torch.from_numpy(np.array(edge + list(rng.integers(
        -2**31, 2**31, 3000)), np.int32))
    y = torch.from_numpy(np.array(edge[::-1] + list(rng.integers(
        -2**31, 2**31, 3000)), np.int32))
    s = torch.from_numpy(np.array([5, -7, 32767, -32768, 1, 3, 60255, 9]
                                  + list(rng.integers(-32768, 32768, 3000)),
                                  np.int32))
    cases = [(spl.norm_u32, (x,)), (spl.norm_w32, (x,)),
             (spl.div_w32_w16, (x, s)), (spl.mul_hi16, (x, s)),
             (spl.scalediff32, (s.abs(), x, y)),
             (spl.agc_scalediff32, (s, x, y)), (spl.agc_mul32, (x, y)),
             (spl.sqrt_i32, (x,)), (spl.shl_u32, (x, y & 31))]
    for fn, args in cases:
        got = fn(*(a.to(device) for a in args)).cpu()
        assert torch.equal(got, fn(*args)), fn.__name__
    frames = torch.from_numpy(rng.integers(-32768, 32768, (64, 160)).astype(
        np.int32))
    st = torch.from_numpy(rng.integers(-2**20, 2**20, (64, 8)).astype(
        np.int32))
    for a, b in zip(spl.downsample_by_2(frames.to(device), st.to(device)),
                    spl.downsample_by_2(frames, st)):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("rate, mode", [(8000, 0), (16000, 3), (32000, 2)])
def test_legacy_vad_on_the_card_equals_the_cpu(device, rate, mode):
    from webrtc_audio_processing_tpu_torch.models.vad import legacy_vad

    rng = np.random.default_rng(rate)
    L = rate // 100
    x = torch.from_numpy(np.clip(rng.normal(size=(64, L * 10)) * 4000,
                                 -32768, 32767).astype(np.int32))
    vad = legacy_vad.LegacyVad(rate, mode)
    gpu = legacy_vad.init_state(64, device)
    cpu = legacy_vad.init_state(64, "cpu")
    for k in range(10):
        fr = x[:, k * L:(k + 1) * L]
        gpu, fg = vad(gpu, fr.to(device))
        cpu, fc = vad(cpu, fr)
        assert torch.equal(fg.cpu(), fc), k
    got, want = apm.state_to_numpy(gpu), apm.state_to_numpy(cpu)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.mark.parametrize("mode", ["ADAPTIVE_ANALOG", "ADAPTIVE_DIGITAL",
                                  "FIXED_DIGITAL"])
def test_gain_control_on_the_card_equals_the_cpu(device, mode):
    """GainControlImpl on the same int16 frames on the card and the CPU,
    two channels, 20 frames: outputs and every state leaf equal (the
    limiter on its kernel on the card, its twin on the CPU)."""
    from webrtc_audio_processing_tpu_torch.models.agc1 import gain_control

    c = gain_control.make_config(cfg_mod.GainController1(
        enabled=True, mode=getattr(cfg_mod.Agc1Mode, mode)), 16000)
    gc = gain_control.GainControl(c)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(np.clip(rng.normal(size=(8, 1, 160 * 20, 2))
                                 * 9000, -32768, 32767).astype(np.int32))
    far = torch.from_numpy(rng.integers(-3000, 3000, (8, 160 * 20)).astype(
        np.int32))
    states = {d: gain_control.init_state(c, 2, 8, d) for d in (device, "cpu")}
    gcs = {device: gc.to(device), "cpu": gain_control.GainControl(c)}
    for k in range(20):
        outs = {}
        for d in (device, "cpu"):
            st = gain_control.process_render_audio(
                c, states[d], far[:, k * 160:(k + 1) * 160].to(d))
            states[d], outs[d] = gcs[d](
                st, x[:, :, k * 160:(k + 1) * 160].to(d))
        assert torch.equal(outs[device].cpu(), outs["cpu"]), k
    got = apm.state_to_numpy(states[device])
    want = apm.state_to_numpy(states["cpu"])
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.mark.parametrize("table", ["_HPF_ROWS", "_HP_IN_POLES",
                                   "_DEC_LOWPASS", "_PITCH_HP_ROWS",
                                   "composite", "upper", "lower"])
def test_k1_on_the_analytics_vad_rows_matches_twin(device, table):
    """K1 on each cascade the analytics VAD runs on it, at 4096 lanes,
    bit-equal to its twin on the card."""
    from webrtc_audio_processing_tpu_torch.models.vad import analytics_vad

    av = analytics_vad
    allpass = table in ("composite", "upper", "lower")
    rows = (av._ROWS[id(getattr(av, f"{table.upper()}_AP"))] if allpass
            else getattr(av, table))
    coeffs = torch.from_numpy(rows).to(device)
    rng = np.random.default_rng(len(table))
    K = rows.shape[0]
    x = torch.from_numpy((rng.standard_normal((240, 4096)) * 3000).astype(
        np.float32)).to(device)
    st = torch.from_numpy((rng.standard_normal((4 * K, 4096)) * 1000).astype(
        np.float32)).to(device)
    st_k, y_k = cuda_biquad.cascade(coeffs, st, x, allpass=allpass)
    st_p, y_p = cuda_biquad.cascade_plain(coeffs, st, x, allpass=allpass)
    assert torch.equal(y_k, y_p) and torch.equal(st_k, st_p)


# ------------------------------------------------------------------ AECM


@pytest.mark.parametrize("order", [7, 8])
def test_int_fft_on_the_card_equals_the_cpu(device, order):
    """The int16 FFT, forward and inverse, card against CPU bit for bit on
    a ragged N = 257 rows of full-scale noise with the extremes; the
    inverse's per-row shift count too."""
    from webrtc_audio_processing_tpu_torch.ops import int_fft

    n = 1 << order
    rng = np.random.default_rng(order)
    x = rng.integers(-32768, 32768, (257, n)).astype(np.int32)
    x[0], x[1], x[2, ::2] = 32767, -32768, -32768
    y = rng.integers(-32768, 32768, (257, n)).astype(np.int32)
    cpu = (torch.from_numpy(x), torch.from_numpy(y))
    card = tuple(t.to(device) for t in cpu)
    for fn in (int_fft.complex_fft_i16, int_fft.complex_ifft_i16):
        got, want = fn(*card, order), fn(*cpu, order)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w), fn.__name__
    h = n // 2 + 1
    got = int_fft.real_inverse_fft_i16(card[0][:, :h], card[1][:, :h], order)
    want = int_fft.real_inverse_fft_i16(cpu[0][:, :h], cpu[1][:, :h], order)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("rate", [8000, 16000])
def test_aecm_process_frame_on_the_card_equals_the_cpu(device, rate):
    """AECM alone, N = 257 cancellers with stream delays from 0 to 500 ms,
    60 frames of an echo scene from startup on, card against CPU: every
    output and state leaf bit for bit on every frame (integer products
    wrap alike, shift counts stay in [0, 31], the uint32 values go through
    int64, the magnitude's float32 square root is corrected to the exact
    integer one)."""
    from webrtc_audio_processing_tpu_torch.models.aecm import (
        echo_control_mobile as ecm,
    )

    N, F = 257, rate // 100
    geo = ecm.AecmGeometry(sample_rate_hz=rate)
    render, capture = chip_smoke.aecm_scene(60, rate, range(N))
    far = torch.from_numpy(np.round(render[..., 0] * 32767).astype(np.int32))
    near = torch.from_numpy(np.round(capture[..., 0] * 32767).clip(
        -32768, 32767).astype(np.int32))
    delay = torch.from_numpy(np.linspace(0, 500, N).astype(np.int32))
    cpu = ecm.init_state(geo, N, "cpu")
    card = ecm.init_state(geo, N, device)
    for f in range(60):
        sl = slice(f * F, (f + 1) * F)
        outs = []
        for st, d in ((cpu, "cpu"), (card, device)):
            st = ecm.buffer_farend(st, far[:, sl].to(d))
            outs.append(ecm.process_frame(geo, st, near[:, sl].to(d),
                                          delay.to(d)))
        (cpu, y_cpu), (card, y_card) = outs
        assert torch.equal(y_card.cpu(), y_cpu), f
    got, want = apm.state_to_numpy(card), apm.state_to_numpy(cpu)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert not cpu.ec_startup.all()


@pytest.mark.parametrize("rate", [16000, 8000])
def test_aecm_pair_graph_equals_eager(device, rate):
    """The fixed profile (HPF, NS, AECM, AGC1 adaptive digital) through
    ``step_graph.PairGraph`` at the period 2, B = 5 for 40 frames from
    init_state, the stream delay an input: every output, AGC1 level and
    at the end every state leaf bit for bit with eager pair steps."""
    geo = chip_smoke.aecm_geometry(rate)
    assert apm.parity_period(geo) == 2
    F = rate // 100
    render, capture = chip_smoke.aecm_scene(40, rate, range(5))
    ren = torch.from_numpy(render).to(device)
    cap = torch.from_numpy(capture).to(device)
    delay = torch.tensor([0, 20, 30, 50, 120], dtype=torch.int32,
                         device=device)
    eager = apm.init_state(geo, 5, device)
    graph = step_graph.PairGraph(geo, apm.init_state(geo, 5, device))
    graph.delay.copy_(delay)
    graph.capture()
    assert sorted(graph.graphs) == [0]
    for p in range(20):
        args = []
        for f in (2 * p, 2 * p + 1):
            sl = slice(f * F, (f + 1) * F)
            args += [ren[:, sl], cap[:, sl]]
        got = graph.replay(*args)
        want = step_graph.step_pair(geo, eager, *args, delay=delay)
        for (g, _, g_st), (w, _, w_st) in zip(got, want):
            assert torch.equal(g, w), p
            assert torch.equal(g_st["agc1_recommended_level"],
                               w_st["agc1_recommended_level"]), p
    got, want = apm.state_to_numpy(graph.state), apm.state_to_numpy(eager)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert not graph.state.aecm.ec_startup.any()


@pytest.mark.parametrize("rate", [16000, 8000])
def test_aecm_frame_graphs_equal_eager(device, rate):
    """The fixed profile through ``step_graph.FrameGraphs`` (two frame
    graphs), B = 3 for 30 frames with the delay an input, against eager
    frames: outputs and every state leaf bit for bit."""
    geo = chip_smoke.aecm_geometry(rate)
    F = rate // 100
    render, capture = chip_smoke.aecm_scene(30, rate, range(3))
    ren = torch.from_numpy(render).to(device)
    cap = torch.from_numpy(capture).to(device)
    delay = torch.tensor([10, 30, 60], dtype=torch.int32, device=device)
    eager = apm.init_state(geo, 3, device)
    graphs = step_graph.FrameGraphs(geo, apm.init_state(geo, 3, device))
    graphs.delay.copy_(delay)
    graphs.capture_graphs()
    assert sorted(graphs.graphs) == [0, 1]
    for f in range(30):
        sl = slice(f * F, (f + 1) * F)
        g, _, _ = graphs.replay(cap[:, sl], ren[:, sl])
        eager, w, _, _ = apm.process_stream_pair(
            geo, eager, cap[:, sl], ren[:, sl], stream_delay_ms=delay)
        assert torch.equal(g, w), f
    got, want = apm.state_to_numpy(graphs.state), apm.state_to_numpy(eager)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_k1_at_the_mobile_hpf_shape_matches_twin(device):
    """K1 at the mobile path's HPF: the 16 kHz table, T = 160, 4096
    lanes, bit-equal to its twin on the card."""
    rng = np.random.default_rng(16)
    coeffs = torch.from_numpy(
        biquad.pack_coeffs(*biquad.HPF_COEFFS[16000])).to(device)
    x = torch.from_numpy((rng.standard_normal((160, 4096)) * 3000).astype(
        np.float32)).to(device)
    st = torch.from_numpy((rng.standard_normal((12, 4096)) * 1000).astype(
        np.float32)).to(device)
    st_k, y_k = cuda_biquad.cascade(coeffs, st, x)
    st_p, y_p = cuda_biquad.cascade_plain(coeffs, st, x)
    assert torch.equal(y_k, y_p) and torch.equal(st_k, st_p)


# ----------------------------------- per-block AEC3, injections, builder


def _stretch(geo, n, seed, batch, device, graph_cls):
    """``n`` frames of the echo scene at the geometry's rate and channels
    (default_48k's 48 kHz stereo, or a variant's) through a graph of
    ``graph_cls`` from init_state and eagerly from an equal state: the
    per-frame outputs and delays of both, and both final states."""
    rate, channels = geo.capture_input_rate, geo.num_capture_channels
    frame = rate // 100
    render, capture = chip_smoke.echo_scene(n, seed, range(batch), rate,
                                            channels)
    ren = torch.from_numpy(render).to(device)
    cap = torch.from_numpy(capture).to(device)
    got, want = [], []
    eager = apm.init_state(geo, batch, device)
    if graph_cls is step_graph.PairGraph:
        graph = graph_cls(geo, apm.init_state(geo, batch, device))
        graph.capture()
        for p in range(n // 2):
            args = []
            for f in (2 * p, 2 * p + 1):
                sl = slice(f * frame, (f + 1) * frame)
                args += [ren[:, sl], cap[:, sl]]
            got += [(o.clone(), st["delay_ms"].clone())
                    for o, _, st in graph.replay(*args)]
            want += [(o, st["delay_ms"])
                     for o, _, st in step_graph.step_pair(geo, eager, *args)]
    else:
        graph = graph_cls(geo, apm.init_state(geo, batch, device))
        graph.capture_graphs()
        for f in range(n):
            sl = slice(f * frame, (f + 1) * frame)
            o, _, st = graph.replay(cap[:, sl], ren[:, sl])
            got.append((o.clone(), st["delay_ms"].clone()))
            eager, o, _, st = apm.process_stream_pair(geo, eager, cap[:, sl],
                                                      ren[:, sl])
            want.append((o, st["delay_ms"]))
    return got, want, graph.state, eager


def _assert_same(got, want, got_state, want_state):
    for f, ((g, gd), (w, wd)) in enumerate(zip(got, want)):
        assert torch.equal(g, w) and torch.equal(gd, wd), f
    g, w = apm.state_to_numpy(got_state), apm.state_to_numpy(want_state)
    assert set(g) == set(w)
    for k in w:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("mode", ["default_48k", "48k_stereo"])
def test_per_block_pair_graph_equals_eager(device, mode):
    """AEC3's per-block path captured as the pair graph, 40 pairs at
    B = 4 against eager pair steps: outputs, delays and every state leaf
    bit for bit; K2 twice a block."""
    geo = chip_smoke.aec3_geometry(mode, False, pair_phase=False)
    chip_smoke._reset_counts()
    got, want, gs, es = _stretch(geo, 80, 8, 4, device, step_graph.PairGraph)
    _assert_same(got, want, gs, es)
    assert int(gs.aec3_block_ordinal) == 200


def test_per_block_pair_kernel_raises(device):
    with pytest.raises(ValueError, match="pair_phase"):
        chip_smoke.aec3_geometry("default_48k", True, pair_phase=False)


def test_per_block_step_on_the_card_equals_the_cpu(device):
    """One per-block step from the same state after 30 frames, card and
    CPU: relative RMS <= 1e-3 per stream and equal delays."""
    geo = chip_smoke.aec3_geometry("default_48k", False, pair_phase=False)
    render, capture = chip_smoke.echo_scene(31, 9, range(3), 48000, 2)
    ren, cap = torch.from_numpy(render), torch.from_numpy(capture)
    state = apm.init_state(geo, 3, device)
    for f in range(30):
        sl = slice(f * 480, (f + 1) * 480)
        state, *_ = apm.process_stream_pair(geo, state, cap[:, sl].to(device),
                                            ren[:, sl].to(device))
    cpu = chip_smoke.select_streams(state, torch.arange(3, device=device),
                                    "cpu")
    sl = slice(30 * 480, 31 * 480)
    _, y_g, _, st_g = apm.process_stream_pair(geo, state, cap[:, sl].to(
        device), ren[:, sl].to(device))
    _, y_c, _, st_c = apm.process_stream_pair(geo, cpu, cap[:, sl],
                                              ren[:, sl])
    rel = chip_smoke._rel_rms(y_g.cpu().numpy(), y_c.numpy())
    assert (rel <= 1e-3).all(), rel
    assert torch.equal(st_g["delay_ms"].cpu(), st_c["delay_ms"])


def test_nree_and_predelay_pair_graph_equals_eager(device):
    """The per-block path with an injected NREE and a 64-sample capture
    pre-delay, graphed and eager, 20 pairs at B = 4: bit for bit."""
    from webrtc_audio_processing_tpu_torch import builder
    from webrtc_audio_processing_tpu_torch.models.aec3 import config as a3

    calls = []
    cfg, _ = a3.validate(a3.EchoCanceller3Config())
    cfg = cfg.replace(delay=dataclasses.replace(
        cfg.delay, fixed_capture_delay_samples=64))
    geo = chip_smoke.aec3_geometry(
        "default_48k", False, pair_phase=False, aec3_cfg=cfg,
        injections=builder.Injections(
            neural_residual_echo_estimator=builder.NeuralResidualEchoEstimator(
                chip_smoke._nree_estimate(calls))))
    got, want, gs, es = _stretch(geo, 40, 10, 4, device,
                                 step_graph.PairGraph)
    _assert_same(got, want, gs, es)
    assert es.aec.capture_predelay.shape[2] == 64
    assert len(calls) == 10 + 100  # the graph's warm-up and capture; eager


def test_injected_frame_graphs_equal_eager_and_half_the_builtin(device):
    """``chip_smoke.smoke_injections`` on default_48k's frame graphs, 40
    frames at B = 4: equal to the eager injected steps on every output and
    leaf, and every output half the built-in AEC3's, bit for bit."""
    inj = chip_smoke.aec3_geometry("default_48k", False,
                                   injections=chip_smoke.smoke_injections())
    got, want, gs, es = _stretch(inj, 40, 11, 4, device,
                                 step_graph.FrameGraphs)
    _assert_same(got, want, gs, es)
    base = chip_smoke.aec3_geometry("default_48k", False)
    _, builtin, _, _ = _stretch(base, 40, 11, 4, device,
                                step_graph.FrameGraphs)
    for (g, gd), (b, bd) in zip(got, builtin):
        assert torch.equal(g, 0.5 * b) and torch.equal(gd, bd)
    assert torch.equal(gs.custom_analyzer["frames"],
                       torch.full((4,), 40, dtype=torch.int32,
                                  device=device))


def test_builder_api_on_the_card_matches_process_stream_pair(device):
    """The builder's API with ``smoke_injections`` and a field trial,
    20 frames against ``apm.process_stream_pair`` at B = 1 on its own
    geometry: bit for bit, delays equal."""
    from webrtc_audio_processing_tpu_torch import builder

    n = 20
    render, capture = chip_smoke.echo_scene(n, 12, [0], 48000, 2)
    inj = chip_smoke.smoke_injections()
    ap = (builder.AudioProcessingBuilder(
        chip_smoke.aec3_config(cfg_mod, "default_48k"))
        .set_field_trials(chip_smoke.BUILDER_TRIALS)
        .set_echo_control_factory(inj.echo_control_factory)
        .set_echo_detector(inj.echo_detector)
        .set_capture_analyzer(inj.capture_analyzer)
        .set_capture_post_processing(inj.capture_post_processing)
        .build(device=device))
    outs, delays = [], []
    for f in range(n):
        sl = slice(f * 480, (f + 1) * 480)
        assert ap.process_reverse_stream(render[0, sl], 48000)[0] == 0
        err, out = ap.process_stream(capture[0, sl], 48000)
        assert err == 0
        outs.append(out)
        delays.append(ap.get_statistics().delay_ms)
    direct, direct_delays = chip_smoke.api_direct_outputs(
        ap._geo, device, render[0], capture[0], n)
    np.testing.assert_array_equal(np.stack(outs), direct)
    assert delays == direct_delays


# ------------------------------------------- AEC3's remaining configurations


@pytest.mark.parametrize("F,W", [(256, 19), (128, 15), (256, 17), (6, 3),
                                 (1664, 19)])
def test_k2_bf16_matches_twin_bit_for_bit(device, F, W):
    """K2's bf16 form (bf16 rows in, float32 out) at default_48k's chain
    reads, the per-block path's, a width off the 8-value vector (the scalar
    form) and 8 render channels' sf rows; it counts its own launches."""
    rng = np.random.default_rng(F + W)
    ring = torch.from_numpy(rng.standard_normal((1024, 200, F)).astype(
        np.float32)).to(device).to(torch.bfloat16)
    start = torch.from_numpy(
        rng.integers(-250, 250, 1024).astype(np.int32)).to(device)
    f32_before, before = cuda_span.launches, cuda_span.launches_bf16
    got = cuda_span.span_gather(ring, start, W)
    want = cuda_span.span_gather_plain(ring, start, W)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert cuda_span.launches_bf16 == before + 1
    assert cuda_span.launches == f32_before


@pytest.mark.parametrize("name", ["default_48k_bf16", "default_48k_ds8",
                                  "pair_kernel_48k_long_coarse",
                                  "aec3_48k_8ch"])
def test_variant_pair_graph_equals_eager(device, name):
    """Each of phase 17's variants captured as the pair graph, 20 pairs at
    B = 4 against eager pair steps: outputs, delays and every state leaf
    bit for bit (the bf16 rings' bits included)."""
    geo = chip_smoke.variant_geometry(name)
    got, want, gs, es = _stretch(geo, 40, 8, 4, device, step_graph.PairGraph)
    _assert_same(got, want, gs, es)


def test_per_block_pair_graph_equals_eager_with_bf16_rings(device):
    """AEC3's per-block path (K2's bf16 form twice a block) with bf16
    rings, graphed against eager, 20 pairs at B = 4, bit for bit."""
    geo = chip_smoke.aec3_geometry("default_48k", False, pair_phase=False,
                                   aec3_ring_dtype="bfloat16")
    before = cuda_span.launches_bf16
    got, want, gs, es = _stretch(geo, 40, 8, 4, device, step_graph.PairGraph)
    _assert_same(got, want, gs, es)
    assert cuda_span.launches_bf16 > before
    assert gs.aec.buffer.sf.dtype == torch.bfloat16


@pytest.mark.parametrize("name", ["default_48k_bf16", "default_48k_ds8",
                                  "aec3_48k_8ch"])
def test_variant_step_on_the_card_equals_the_cpu(device, name):
    """One step of a variant from the same state after 30 frames, card and
    CPU: relative RMS <= 1e-3 per stream and equal delays."""
    geo = chip_smoke.variant_geometry(name)
    rate, channels = geo.capture_input_rate, geo.num_capture_channels
    frame = rate // 100
    render, capture = chip_smoke.echo_scene(31, 9, range(3), rate, channels)
    ren, cap = torch.from_numpy(render), torch.from_numpy(capture)
    state = apm.init_state(geo, 3, device)
    for f in range(30):
        sl = slice(f * frame, (f + 1) * frame)
        state, *_ = apm.process_stream_pair(geo, state, cap[:, sl].to(device),
                                            ren[:, sl].to(device))
    cpu = chip_smoke.select_streams(state, torch.arange(3, device=device),
                                    "cpu")
    sl = slice(30 * frame, 31 * frame)
    _, y_g, _, st_g = apm.process_stream_pair(geo, state, cap[:, sl].to(
        device), ren[:, sl].to(device))
    _, y_c, _, st_c = apm.process_stream_pair(geo, cpu, cap[:, sl],
                                              ren[:, sl])
    rel = chip_smoke._rel_rms(y_g.cpu().numpy(), y_c.numpy())
    assert (rel <= 1e-3).all(), rel
    assert torch.equal(st_g["delay_ms"].cpu(), st_c["delay_ms"])


def test_long_coarse_filter_launches_no_k6(device):
    """The pair kernel with a coarse filter longer than the refined one:
    the frames run the plain subtractor, K6 launches 0 times, and the
    rest of the path launches as ``expected_aec3_launches`` gives."""
    geo = chip_smoke.variant_geometry("pair_kernel_48k_long_coarse")
    assert geo.aec3.pair_kernel
    render, capture = chip_smoke.echo_scene(4, 9, range(4), 48000, 2)
    ren = torch.from_numpy(render).to(device)
    cap = torch.from_numpy(capture).to(device)
    state = apm.init_state(geo, 4, device)
    chip_smoke._reset_counts()
    for f in range(4):
        sl = slice(f * 480, (f + 1) * 480)
        state, out, _, _ = apm.process_stream_pair(geo, state, cap[:, sl],
                                                   ren[:, sl])
    counts = chip_smoke._counts()
    assert counts["subtractor_pair"] == 0
    assert counts == chip_smoke.expected_aec3_launches(geo, 4)


# ------------------------------------------------ host tooling (PR 14)


def test_aec_dump_recorded_and_replayed_on_the_card(device, tmp_path):
    """``Config()``'s pipeline with HPF, AEC3, NS and AGC2 at 48 kHz stereo
    through the API on the card, 12 frames of an echo scene with a dump
    attached, then the dump replayed on the card with the same config:
    every replayed frame bit-equal to the recorded one."""
    from webrtc_audio_processing_tpu_torch import api
    from webrtc_audio_processing_tpu_torch.utils import aec_dump

    cfg = chip_smoke.aec3_config(cfg_mod, "default_48k")
    render, capture = chip_smoke.echo_scene(12, 9, range(1), 48000, 2)
    ap = api.AudioProcessing(cfg, device=device)
    path = str(tmp_path / "card.aecdump")
    ap.attach_aec_dump(path)
    outs = []
    for f in range(12):
        sl = slice(f * 480, (f + 1) * 480)
        ap.process_reverse_stream(render[0, sl], 48000)
        outs.append(ap.process_stream(capture[0, sl], 48000)[1])
    ap.detach_aec_dump()
    pairs = aec_dump.replay(path, config=cfg, device=device)
    assert len(pairs) == 12
    for f, (recorded, replayed) in enumerate(pairs):
        np.testing.assert_array_equal(recorded, outs[f])
        np.testing.assert_array_equal(replayed, recorded)


def test_checkpoint_packed_on_the_card_steps_on_the_cpu(device):
    """``default_48k`` at B = 3 after 30 frames on the card, packed there
    and unpacked into a CPU state: every leaf the card's bit for bit, and
    one more frame from it on the CPU within the card-vs-CPU bar (relative
    RMS <= 1e-3 per stream, equal delays) of the card's frame."""
    from webrtc_audio_processing_tpu_torch.utils import checkpoint

    geo = chip_smoke.aec3_geometry("default_48k")
    render, capture = chip_smoke.echo_scene(31, 9, range(3), 48000, 2)
    ren, cap = torch.from_numpy(render), torch.from_numpy(capture)
    state = apm.init_state(geo, 3, device)
    for f in range(30):
        sl = slice(f * 480, (f + 1) * 480)
        state, *_ = apm.process_stream_pair(geo, state, cap[:, sl].to(device),
                                            ren[:, sl].to(device))
    cpu = checkpoint.unpack(checkpoint.pack(state),
                            apm.init_state(geo, 3, "cpu"))
    assert cpu.frame_counter == 30
    g, c = apm.state_to_numpy(state), apm.state_to_numpy(cpu)
    assert g.keys() == c.keys()
    for k in g:
        np.testing.assert_array_equal(c[k], g[k], err_msg=k)
    sl = slice(30 * 480, 31 * 480)
    _, y_g, _, st_g = apm.process_stream_pair(geo, state, cap[:, sl].to(
        device), ren[:, sl].to(device))
    _, y_c, _, st_c = apm.process_stream_pair(geo, cpu, cap[:, sl],
                                              ren[:, sl])
    rel = chip_smoke._rel_rms(y_g.cpu().numpy(), y_c.numpy())
    assert (rel <= 1e-3).all(), rel
    assert torch.equal(st_g["delay_ms"].cpu(), st_c["delay_ms"])


def test_two_shards_on_one_card_on_two_streams(device):
    """``graft_entry.ShardedPairStep`` with two shards on cuda:0, each its
    own pair graph replayed on its own CUDA stream under the launchers'
    device check, 6 pairs of 48 kHz stereo at B = 6 against the unsharded
    pair graph: outputs within 1e-6, every kernel launched by each
    shard's capture as by the unsharded one's."""
    from webrtc_audio_processing_tpu_torch import graft_entry

    geo = graft_entry.geometry(48000, 2, 2, 48000)
    render, capture = chip_smoke.echo_scene(12, 9, range(6), 48000, 2)
    ren = torch.from_numpy(render).to(device)
    cap = torch.from_numpy(capture).to(device)
    dev0 = torch.device("cuda", 0)
    whole = step_graph.PairGraph(geo, apm.init_state(geo, 6, dev0))
    chip_smoke._reset_counts()
    whole.capture()
    one = chip_smoke._counts()
    sharded = graft_entry.ShardedPairStep(geo, apm.init_state(geo, 6, dev0),
                                          [dev0, dev0])
    chip_smoke._reset_counts()
    sharded.capture()
    assert chip_smoke._counts() == {k: 2 * v for k, v in one.items()}
    assert sharded.graphs[0].stream != sharded.graphs[1].stream
    for p in range(6):
        args = []
        for f in (2 * p, 2 * p + 1):
            sl = slice(f * 480, (f + 1) * 480)
            args += [ren[:, sl], cap[:, sl]]
        want = [o.clone() for o, _, _ in whole.replay(*args)]
        got = [o for o, _ in sharded.step(*args)]
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=1e-6)
    torch.cuda.synchronize()
