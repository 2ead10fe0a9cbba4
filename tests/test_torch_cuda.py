"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs an NVIDIA GPU and nvcc and skips without them. On a
machine with a card (no JAX needed):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

import chip_smoke

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
@pytest.mark.parametrize("K", [1, 2, 3, 4])
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


@pytest.mark.parametrize("table", ["decimator", "post_filter"])
def test_k1_new_callers_match_twin_bit_for_bit(device, table):
    """K1 at the AEC3 decimators' shape (4 sections, one signal per stream,
    T = 64) and the PostFilter's (4 sections, 2 channels, T = 480)."""
    coeffs, T, M = {
        "decimator": (_decimator_table(), 64, 2048),
        "post_filter": (biquad.pack_coeffs(post_filter.COEFFS_B_48K,
                                           post_filter.COEFFS_A_48K),
                        480, 4096),
    }[table]
    rng = np.random.default_rng(11)
    c = torch.from_numpy(coeffs).to(device)
    x = torch.from_numpy(
        (rng.standard_normal((T, M)) * 3000).astype(np.float32)).to(device)
    st = torch.from_numpy(
        (rng.standard_normal((16, M)) * 100).astype(np.float32)).to(device)
    st_k, y_k = cuda_biquad.cascade(c, st, x)
    st_p, y_p = cuda_biquad.cascade_plain(c, st, x)
    torch.cuda.synchronize()
    assert torch.equal(y_k, y_p) and torch.equal(st_k, st_p)


@pytest.mark.parametrize("F,W", [(512, 19), (384, 15), (6, 3)])
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
                                              ("16k_mono", True)])
def test_pair_graph_replays_equal_eager_pair_steps(device, mode,
                                                   pair_kernel):
    """The pair step captured as one CUDA graph and replayed for 40 pairs
    (200 blocks, past the 48 kHz stereo ring's wrap at L = 167) at B = 4,
    against the same pairs run eagerly from an equal state: every output,
    every delay and, at the end, every state leaf bit for bit, the block
    ordinal included."""
    geo = chip_smoke.aec3_geometry(mode, pair_kernel)
    rate, channels, _ = chip_smoke.BENCH_MODES[mode]
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
