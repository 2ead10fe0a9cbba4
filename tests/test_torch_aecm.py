"""AECM and its int16 FFT against the JAX package on the CPU, bit for bit:
the int FFT at orders 7 and 8, the tables, the Q helpers, the binary delay
estimator, the magnitude, the comfort noise's LCG, ``process_block`` in
every echo mode with comfort noise on and off, and ``process_frame`` at 8
and 16 kHz from startup on, every state leaf and output equal. The JAX
functions compile once each, side by side, in a module fixture."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webrtc_audio_processing_tpu.models.aecm import core as j_core
from webrtc_audio_processing_tpu.models.aecm import (
    echo_control_mobile as j_ecm,
)
from webrtc_audio_processing_tpu.ops import int_fft as j_fft

from webrtc_audio_processing_tpu_torch import apm
from webrtc_audio_processing_tpu_torch.models.aecm import core
from webrtc_audio_processing_tpu_torch.models.aecm import (
    echo_control_mobile as ecm,
)
from webrtc_audio_processing_tpu_torch.ops import int_fft

from tests.torch_agc1_util import assert_states, batched, compile_all, t

RNG = np.random.default_rng(3)
N_BLOCKS = 60
N_FRAMES = 80
# (echo mode, comfort noise, mult) of the process_block cases.
BLOCK_CASES = [(m, cng, 2) for cng in (False, True) for m in range(5)] + [
    (3, True, 1)]
FRAME_RATES = (8000, 16000)
DELAYS = np.array([0, 30, 120, 500], np.int32)


def to_port(template, jtree):
    return apm.tree_to_state(template, jax.tree_util.tree_map(np.asarray,
                                                              jtree))


def speech_like_blocks(n_blocks, rows, seed):
    """(rows, n_blocks * 64) int32: speech-like far-end bursts with level
    dynamics (tests/test_aecm.py's), and the near end: its echo 7 blocks
    late with tests/test_aecm.py's smear, plus a little noise."""
    rng = np.random.default_rng(seed)
    n = n_blocks * 64
    tt = np.arange(n) / 16000
    burst = (np.sin(2 * np.pi * 2.7 * tt) > -0.3)
    level = 0.08 + 0.92 * np.abs(np.sin(2 * np.pi * 0.31 * tt))
    far = (rng.normal(size=(rows, n)) * 9000 * burst * level).clip(
        -30000, 30000)
    fd = np.roll(far, 7 * 64, 1)
    near = (0.5 * fd + 0.2 * np.roll(fd, 1, 1) + 0.1 * np.roll(fd, 2, 1)
            + 30 * rng.normal(size=(rows, n)))
    return far.astype(np.int32), near.astype(np.int32)


def frame_scene(rate, n_frames, rows, seed):
    """(rows, samples) int32 far and near ends at ``rate``: the far end's
    bursts and the echo 30 ms late with the smear."""
    rng = np.random.default_rng(seed)
    n = n_frames * rate // 100
    tt = np.arange(n) / rate
    burst = (np.sin(2 * np.pi * 2.7 * tt) > -0.3)
    level = 0.08 + 0.92 * np.abs(np.sin(2 * np.pi * 0.31 * tt))
    far = (rng.normal(size=(rows, n)) * 9000 * burst * level).clip(
        -30000, 30000)
    fd = np.roll(far, 3 * rate // 100, 1)
    near = 0.5 * fd + 0.2 * np.roll(fd, 1, 1) + 0.1 * np.roll(fd, 2, 1)
    return far.astype(np.int32), near.astype(np.int32)


def _block_start(mode, rows):
    """A JAX core state of ``rows`` cancellers, one in each startup phase
    (tot_count 0, 520 and 1100 blocks: startup 0, 1 and 2)."""
    js = batched(j_core.init_core(16000, mode), rows)
    return js.replace(tot_count=jnp.asarray([0, 520, 1100][:rows],
                                            jnp.int32))


@pytest.fixture(scope="module")
def compiled():
    jobs = {}
    far, near = speech_like_blocks(1, 3, 0)
    for mode, cng, mult in BLOCK_CASES:
        def fn(s, f, x, mode=mode, cng=cng, mult=mult):
            return jax.vmap(lambda s, f, x: j_core.process_block(
                s, f, x, mult, echo_mode=mode, cng=cng))(s, f, x)
        jobs[("block", mode, cng, mult)] = (fn, (_block_start(mode, 3),
                                                 far, near))
    for rate in FRAME_RATES:
        geo = j_ecm.AecmGeometry(sample_rate_hz=rate)
        F = rate // 100
        js = batched(j_ecm.init_state(geo), len(DELAYS))

        def step(s, f, x, d, parity, geo=geo):
            return jax.vmap(lambda s, f, x, d: j_ecm.process_frame(
                geo, j_ecm.buffer_farend(s, f), x, parity, d))(s, f, x, d)
        zeros = np.zeros((len(DELAYS), F), np.int32)
        jobs[("frame", rate)] = (step, (js, zeros, zeros, DELAYS,
                                        jnp.int32(0)))

    def delay_steps(de, far, near):
        return jax.vmap(lambda d, f, x: j_core.delay_estimator_process(
            d, f, 0, x, 0))(de, far, near)
    de = batched(j_core.init_delay_estimator(), 2)
    z = np.zeros((2, 65), np.int32)
    jobs["delay"] = (delay_steps, (de, z, z))
    jobs["ttf"] = (jax.vmap(j_core._time_to_frequency),
                   (np.zeros((4, 128), np.int32),))
    return compile_all(jobs)


# ------------------------------------------------------------------ int FFT


def _fft_rows(n, seed):
    """Seeded int16 rows with the extremes: +-32767, -32768 and an
    alternating full-scale row."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-32768, 32768, (24, n)).astype(np.int32)
    x[0], x[1] = 32767, -32768
    x[2, ::2], x[2, 1::2] = -32768, 32767
    x[3] = 0
    x[4, 0] = -32768
    x[5] = rng.integers(-300, 300, n)  # small: the IFFT shifts little
    return x


@pytest.mark.parametrize("order", [7, 8])
@pytest.mark.parametrize("kind", ["complex_fft", "complex_ifft",
                                  "real_forward", "real_inverse"])
def test_int_fft_matches_jax(kind, order):
    n = 1 << order
    re, im = _fft_rows(n, order), _fft_rows(n, order + 10)
    if kind == "complex_fft":
        got = int_fft.complex_fft_i16(t(re), t(im), order)
        want = j_fft.complex_fft_i16(jnp.asarray(re), jnp.asarray(im), order)
    elif kind == "complex_ifft":
        got = int_fft.complex_ifft_i16(t(re), t(im), order)
        want = j_fft.complex_ifft_i16(jnp.asarray(re), jnp.asarray(im),
                                      order)
    elif kind == "real_forward":
        got = int_fft.real_forward_fft_i16(t(re), order)
        want = j_fft.real_forward_fft_i16(jnp.asarray(re), order)
    else:
        h = n // 2 + 1
        got = int_fft.real_inverse_fft_i16(t(re[:, :h]), t(im[:, :h]), order)
        want = j_fft.real_inverse_fft_i16(jnp.asarray(re[:, :h]),
                                          jnp.asarray(im[:, :h]), order)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if kind in ("complex_ifft", "real_inverse"):
        # The per-row shift count (out_cfft) is a tensor, and it varies.
        assert len(set(got[-1].tolist())) > 1


def test_twiddle_table_is_the_truncated_sine():
    i = np.arange(1024)
    want = [math.trunc(32767 * math.sin(2 * math.pi * k / 1024)) for k in i]
    np.testing.assert_array_equal(int_fft.SIN_1024, want)
    np.testing.assert_array_equal(int_fft.SIN_1024, j_fft._SIN_1024)


# ------------------------------------------------------- tables and helpers


def test_tables_match_jax():
    for name in ("SQRT_HANNING", "COS_TABLE", "SIN_TABLE",
                 "CHANNEL_STORED_8K", "CHANNEL_STORED_16K"):
        np.testing.assert_array_equal(getattr(core, name),
                                      np.asarray(getattr(j_core, name)),
                                      err_msg=name)
    assert core.COS_TABLE[90] == 0 and core.SIN_TABLE[90] == 8191


@pytest.mark.parametrize("mode", range(5))
def test_sup_gain_params_and_init_match_jax(mode):
    assert core.sup_gain_params(mode) == j_core.sup_gain_params(mode)
    for rate in (8000, 16000):
        got = core.init_core(rate, mode, 2, "cpu")
        assert_states(got, batched(j_core.init_core(rate, mode), 2))


def test_norm_w16_and_log_of_energy_match_jax():
    """Including energies whose uint32 bit pattern is negative as int32
    (the C sums wrap mod 2^32) and the zero energy."""
    e = np.array([0, 1, 2, 3, 1 << 20, 0x7FFFFFFF, -1, -2, -0x80000000,
                  -12345678, 65535, 65536, 99999, 123456789], np.int32)
    q = np.array([0, 3, 15, 12, 27, 0, 1, 5, 9, 14, 2, 0, 7, 28], np.int32)
    np.testing.assert_array_equal(
        core.log_of_energy_q8(t(e), t(q)).numpy(),
        np.asarray(j_core._log_of_energy_q8(jnp.asarray(e), jnp.asarray(q))))
    x = np.concatenate([np.arange(-32768, 32768, 7), [32767, -32768, 0, 1,
                                                      -1, 32768]])
    x = x.astype(np.int32)
    np.testing.assert_array_equal(
        core.norm_w16(t(x)).numpy(),
        np.asarray(j_core._norm_w16(jnp.asarray(x))))


def test_bit_count_on_uint32_extremes():
    u = np.array([0, 1, 2, 3, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF,
                  0x55555555, 0xAAAAAAAA, 0x01010101, 0xFFFF0000,
                  0xDEADBEEF], np.uint32)
    u = np.concatenate([u, RNG.integers(0, 2**32, 200).astype(np.uint32)])
    got = core.bit_count(torch.from_numpy(u.astype(np.int64))).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(j_core._bit_count(jnp.asarray(u))))
    np.testing.assert_array_equal(got, [bin(int(v)).count("1") for v in u])


def test_delay_estimator_matches_jax_and_locks(compiled):
    """tests/test_aecm.py:49's synthetic case on two rows (the near end
    the far end 7 and 12 blocks late): every state leaf and the delay
    equal on each of 240 steps, both locked."""
    seq = RNG.integers(1, 30000, size=(240, 65)).astype(np.int32)
    js = batched(j_core.init_delay_estimator(), 2)
    ps = core.init_delay_estimator(2, "cpu")
    zero = torch.zeros(2, dtype=torch.int32)
    for k in range(240):
        far = np.stack([seq[k], seq[k]])
        near = np.stack([seq[k - 7] if k >= 7 else seq[0],
                         seq[k - 12] if k >= 12 else seq[0]])
        js, jd = compiled["delay"](js, far, near)
        ps, pd = core.delay_estimator_process(ps, t(far), zero, t(near), zero)
        np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    assert_states(ps, js)
    assert pd.tolist() == [7, 12]


def test_magnitude_on_every_square_neighbour():
    """floor(sqrt) of every k^2 - 1, k^2 and k^2 + 1 up to 2 * 32767^2
    (and 2^31, both parts -32768): the port's float32 estimate with its two
    integer steps against the JAX package's arithmetic on XLA:CPU and the
    exact integer square root."""
    top = 2 * 32767 ** 2
    k = np.arange(1, math.isqrt(top) + 2, dtype=np.int64)
    sq = np.unique(np.concatenate([k * k - 1, k * k, k * k + 1, [0, top,
                                                                 1 << 31]]))
    sq = sq[sq <= max(top, 1 << 31)]
    got = core.floor_sqrt(torch.from_numpy(sq)).numpy()
    # The JAX package's lines (core.py _time_to_frequency) on the same sq.
    u = jnp.asarray(sq.astype(np.uint32))
    s = jnp.floor(jnp.sqrt(u.astype(jnp.float32))).astype(jnp.uint32)
    s = jnp.where(s * s > u, s - 1, s)
    s = jnp.where((s + 1) * (s + 1) <= u, s + 1, s)
    np.testing.assert_array_equal(got, np.asarray(s).astype(np.int64))
    np.testing.assert_array_equal(got, [math.isqrt(int(v)) for v in sq])


def test_time_to_frequency_matches_jax(compiled):
    buf = np.concatenate([_fft_rows(128, 5)[:6],
                          RNG.integers(-2000, 2000, (6, 128))]).astype(
                              np.int32)
    for rows in (buf[:4], buf[4:8], buf[8:]):
        want = compiled["ttf"](rows)
        got = core.time_to_frequency(t(rows))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", [666, 0, 2**32 - 1])
def test_lcg_jump_ahead_equals_64_steps(seed):
    s, draws = seed, []
    for _ in range(64):
        s = (s * 69069 + 1) & 0xFFFFFFFF
        draws.append((s >> 16) & 0x7FFF)
    got, new = core.lcg_draws(torch.tensor([seed, seed], dtype=torch.int64))
    assert got.tolist() == [draws, draws] and new.tolist() == [s, s]


@pytest.mark.parametrize("rate", FRAME_RATES)
def test_geometry_and_echo_likelihood_match_jax(rate):
    """AecmGeometry's frame length, mult, period and block schedule, and
    get_echo_likelihood on suppression gains across its range."""
    geo, jgeo = (m.AecmGeometry(sample_rate_hz=rate) for m in (ecm, j_ecm))
    for name in ("frame_len", "mult", "period", "schedule"):
        assert getattr(geo, name) == getattr(jgeo, name), name
    gains = np.array([0, 1, 128, 256, 600], np.int32)
    js = batched(j_ecm.init_state(jgeo), len(gains))
    js = js.replace(core=js.core.replace(sup_gain=jnp.asarray(gains)))
    ps = to_port(ecm.init_state(geo, len(gains), "cpu"), js)
    np.testing.assert_array_equal(
        ecm.get_echo_likelihood(ps).numpy(),
        np.asarray(jax.vmap(j_ecm.get_echo_likelihood)(js)))


# ----------------------------------------------------------- process_block


@pytest.mark.parametrize("mode,cng,mult", BLOCK_CASES)
def test_process_block_matches_jax(compiled, mode, cng, mult):
    """60 blocks at N = 3 (one canceller in each startup phase) of an echo
    scene: every output and, every 10 blocks and at the end, every state
    leaf equal."""
    step = compiled[("block", mode, cng, mult)]
    js = _block_start(mode, 3)
    ps = to_port(core.init_core(16000, mode, 3, "cpu"), js)
    far, near = speech_like_blocks(N_BLOCKS, 3, 10 * mode + cng + mult)
    vad = []
    for b in range(N_BLOCKS):
        f, x = far[:, b * 64:(b + 1) * 64], near[:, b * 64:(b + 1) * 64]
        js, jy = step(js, f, x)
        ps, py = core.process_block(ps, t(f), t(x), mult, echo_mode=mode,
                                    cng=cng)
        np.testing.assert_array_equal(py.numpy(), np.asarray(jy),
                                      err_msg=f"block {b}")
        vad.append(ps.current_vad_value.numpy().copy())
        if b % 10 == 9:
            assert_states(ps, js)
    # The scene moved the canceller: the VAD fired and the gains adapted.
    assert (np.stack(vad) == 1).any()
    assert (np.asarray(js.channel_adapt16)
            != core.CHANNEL_STORED_16K).any()


# ----------------------------------------------------------- process_frame


@pytest.fixture(scope="module")
def frame_runs(compiled):
    """process_frame at 8 and 16 kHz, N = 4 with stream delays 0, 30, 120
    and 500 ms, 80 frames: the JAX package's ``parity`` argument takes k %
    4 (the port has none). Per frame: the outputs and whether every state
    leaf was equal, and each row's rebuf_fill and ec_startup."""
    out = {}
    for rate in FRAME_RATES:
        geo = ecm.AecmGeometry(sample_rate_hz=rate)
        F = geo.frame_len
        far, near = frame_scene(rate, N_FRAMES, len(DELAYS), rate)
        js = batched(j_ecm.init_state(j_ecm.AecmGeometry(sample_rate_hz=rate)),
                     len(DELAYS))
        ps = to_port(ecm.init_state(geo, len(DELAYS), "cpu"), js)
        r = {"equal_outputs": [], "equal_states": [], "fill": [],
             "startup": [], "near": near, "out": []}
        for k in range(N_FRAMES):
            f, x = far[:, k * F:(k + 1) * F], near[:, k * F:(k + 1) * F]
            js, jy = compiled[("frame", rate)](js, f, x, DELAYS,
                                               jnp.int32(k % 4))
            ps = ecm.buffer_farend(ps, t(f))
            ps, py = ecm.process_frame(geo, ps, t(x), t(DELAYS))
            r["equal_outputs"].append(np.array_equal(py.numpy(),
                                                     np.asarray(jy)))
            try:
                assert_states(ps, js)
                r["equal_states"].append(True)
            except AssertionError:
                r["equal_states"].append(False)
            r["fill"].append(ps.rebuf_fill.numpy().copy())
            r["startup"].append(ps.ec_startup.numpy().copy())
            r["out"].append(py.numpy())
        r["out"] = np.concatenate(r["out"], 1)
        out[rate] = r
    return out


@pytest.mark.parametrize("rate", FRAME_RATES)
def test_process_frame_matches_jax_every_frame(frame_runs, rate):
    r = frame_runs[rate]
    assert all(r["equal_outputs"]), r["equal_outputs"].index(False)
    assert all(r["equal_states"]), r["equal_states"].index(False)


@pytest.mark.parametrize("rate", FRAME_RATES)
def test_startup_exits_on_different_frames(frame_runs, rate):
    """Each stream delay leaves startup on its own frame, and every stream
    has left it within the 80 frames."""
    startup = np.stack(frame_runs[rate]["startup"])  # (frames, rows)
    exits = [int(np.argmin(startup[:, i])) for i in range(len(DELAYS))]
    assert not startup[-1].any(), exits
    assert len(set(exits)) > 1, exits


@pytest.mark.parametrize("rate", FRAME_RATES)
def test_rebuffer_fill_cycles(frame_runs, rate):
    """Once enabled, rebuf_fill cycles through {0, 16, 32, 48}: two
    values a frame apart at 16 kHz (two sub-frames a frame), all four at
    8 kHz (tests/test_aecm.py:136)."""
    fill = np.stack(frame_runs[rate]["fill"])[-16:]
    for i in range(len(DELAYS)):
        seen = set(fill[:, i].tolist())
        assert seen <= {0, 16, 32, 48}
        assert len(seen) == (2 if rate == 16000 else 4), seen


def test_process_frame_cancels_echo(frame_runs):
    """The canceller works: over the last third at 16 kHz, the stream with
    the true 30 ms delay reported loses most of its echo."""
    r = frame_runs[16000]
    n = r["out"].shape[1]
    tail = slice(2 * n // 3, n)
    e_in = np.mean(r["near"][1, tail].astype(np.float64) ** 2)
    e_out = np.mean(r["out"][1, tail].astype(np.float64) ** 2)
    assert 10 * np.log10(e_in / e_out) > 8.0
