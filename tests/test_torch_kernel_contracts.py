"""The contracts that K1's and K5's kernels rest on, checked on the CPU.

- K1's kernel evaluates each multiply-add of the cascade as one float32
  FFMA (a single rounding). Its plain twin rounds the double sum of the
  exact product and c to float, which rounds twice. The two agree on every
  multiply-add the twin does on the port's tables (HPF at 16, 32 and
  48 kHz, PostFilter, AEC3 decimators at factors 4 and 8, and the QMF's
  all-pass rows in the all-pass form) over noise, so kernel and twin can
  agree bit for bit. At five sections (the factor-8 decimators' band-pass
  cascade) the twin also equals the JAX package's scan bit for bit, and a
  sixth section raises. The reference here is an exact fma in numpy: the
  double sum made exact by TwoSum and rounded to odd, then to float.
- K5's twin gives ``lax.dynamic_slice``'s windows for int32 and int64
  starts alike, negative and past the end, at every start residue mod 4
  (the kernel's 16-byte lines).
- K3's and K4's kernels sum in their own order (K3: an FMA chain over a
  lane's taps, then a pairwise tree over the 32 lanes; K4: FMA chains
  over each chunk, a running prefix in the lane, then a Hillis-Steele scan
  of the lane totals). Numpy models of those orders are held to the JAX
  oracles (``pallas_mf._nlms_scan``, ``pallas_pre_echo.pre_echo_inst_xla``)
  at the kernels' bars, on inputs with near-converged filters and x^2
  near the gate's threshold, so the kernels' order, not only the twins',
  stays inside them.
- K6 computes each 128-point real transform as a warp's 64-point complex
  FFT plus the real split or merge, pruned by the half-zero inputs and
  half-read outputs. A numpy model of that order is held to ``np.fft`` in
  float64 for its four uses (the prediction tail, the error transform,
  the constrain's head and forward), bins 0 and 64 of an inverse read as
  real.
- ``cuda_build.ptxas_lines`` keeps each kernel's entry line with its
  registers and spills (``chip_smoke.py``'s build phase prints them).
- The K2, K3 and K5 wrappers refuse an index that is not of their integer
  type and data that is not float32, on the CPU path and before the
  launch.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from tests import torch_threads  # noqa: F401  (one thread a worker)
from webrtc_audio_processing_tpu.ops import (
    pallas_biquad,
    pallas_mf,
    pallas_pre_echo,
)

from webrtc_audio_processing_tpu_torch.models import post_filter
from webrtc_audio_processing_tpu_torch.models.aec3 import render_buffer
from webrtc_audio_processing_tpu_torch.models.vad import analytics_vad as av
from webrtc_audio_processing_tpu_torch.ops import (
    biquad,
    cuda_biquad,
    cuda_build,
    cuda_matched_filter,
    cuda_span,
    cuda_window,
    qmf,
)


def exact_fma(a, b, c):
    """float32(a * b + c) with one rounding, for float32 a, b, c: the
    product is exact in double; TwoSum gives the double sum's error; the
    sum is rounded to odd (moved one ulp toward the error where it is
    inexact and even), which 53 >= 24 + 2 bits make safe to round to
    float32 once more."""
    p = np.float64(a) * np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(np.int64) & 1) == 0
    toward = np.where(err > 0, np.inf, -np.inf)
    s = np.where((err != 0) & even, np.nextafter(s, toward), s)
    return s.astype(np.float32)


def test_exact_fma_sees_a_double_rounding():
    """A sum whose double rounding lands on a float32 tie: the twin's form
    rounds it to even (1.0), the single rounding up (1 + 2**-23)."""
    a = np.float32((2 ** 23 + 2896) * 2.0 ** -23)
    b = np.float32((2 ** 23 - 2895) * 2.0 ** -47)
    c = np.float32(1.0)
    twin = cuda_biquad._fused(float(a), torch.tensor([b]), torch.tensor([c]))
    assert twin.item() == 1.0
    assert exact_fma(a, [b], [c])[0] == np.float32(1 + 2.0 ** -23)


def _tables():
    aa, nr = render_buffer.decimator_coeffs()
    tables = {f"hpf_{rate}": biquad.pack_coeffs(*biquad.HPF_COEFFS[rate])
              for rate in (16000, 32000, 48000)}
    tables["post_filter"] = biquad.pack_coeffs(post_filter.COEFFS_B_48K,
                                               post_filter.COEFFS_A_48K)
    tables["decimator"] = np.concatenate([aa, nr])
    tables["decimator_ds8"] = render_buffer.decimator_coeffs(8)[0]
    tables["qmf_1"] = qmf.allpass_rows(qmf.ALLPASS_COEF_1)
    tables["qmf_2"] = qmf.allpass_rows(qmf.ALLPASS_COEF_2)
    # The analytics VAD's IIRs on K1 (models/vad/analytics_vad.py).
    for name, f in (("composite", av.COMPOSITE_AP), ("upper", av.UPPER_AP),
                    ("lower", av.LOWER_AP)):
        tables[f"vad_allpass_{name}"] = av._ROWS[id(f)]
    tables["vad_input_hpf_poles"] = av._HP_IN_POLES
    tables["vad_decimated_lowpass"] = av._DEC_LOWPASS
    tables["vad_pitch_hpf"] = av._PITCH_HP_ROWS
    tables["vad_pole_zero_hpf"] = av._HPF_ROWS
    return tables


_ALLPASS_TABLES = {"qmf_1", "qmf_2", "vad_allpass_composite",
                   "vad_allpass_upper", "vad_allpass_lower"}


@pytest.mark.parametrize("table", sorted(_tables()))
def test_twin_fma_is_single_rounding_on_every_table(table, monkeypatch):
    """Every multiply-add of the twin over 64 lanes x 480 samples of noise
    (std 3000, state std 1000) equals the exact fma bit for bit."""
    coeffs = torch.from_numpy(_tables()[table])
    K = coeffs.shape[0]
    rng = np.random.default_rng(K * 1000 + len(table))
    x = torch.from_numpy((rng.standard_normal((480, 64)) * 3000).astype(
        np.float32))
    st = torch.from_numpy((rng.standard_normal((4 * K, 64)) * 1000).astype(
        np.float32))
    fused = cuda_biquad._fused
    checked, differ = [0], [0]

    def checking(a, b, c):
        got = fused(a, b, c)
        want = exact_fma(np.float32(a), b.numpy(), c.numpy())
        differ[0] += int((got.numpy().view(np.int32)
                          != want.view(np.int32)).sum())
        checked[0] += got.numel()
        return got

    monkeypatch.setattr(cuda_biquad, "_fused", checking)
    allpass = table in _ALLPASS_TABLES
    cuda_biquad.cascade(coeffs, st, x, allpass=allpass)
    # b0 == 1 or b2 == 1 drops one fused op of a section (module docstring);
    # the all-pass form has one.
    per_section = 1 if allpass else 2
    assert checked[0] >= 480 * 64 * K * per_section
    assert differ[0] == 0, f"{differ[0]} of {checked[0]} multiply-adds"


def test_k1_twin_matches_jax_scan_at_five_sections():
    """K1's twin at K = 5 on the factor-8 decimators' band-pass table
    (b0 and b2 not 1, b1 = 0: no select folds) against the jitted JAX
    cascade (``make_cascade``'s scan as XLA:CPU contracts it), over 64
    samples from a random state, bit for bit; K = 6 raises, naming the
    limit."""
    aa = render_buffer.decimator_coeffs(8)[0]
    b, a = aa[:, :3], aa[:, 3:]
    K, M, T = 5, 6, 64
    rng = np.random.default_rng(58)
    x = (rng.standard_normal((M, T)) * 3000).astype(np.float32)
    st = (rng.standard_normal((M, K, 4)) * 100).astype(np.float32)
    want_st, want_y = jax.jit(jax.vmap(pallas_biquad.make_cascade(b, a)))(
        st, x)
    got_st, got_y = cuda_biquad.cascade(
        torch.from_numpy(aa),
        torch.from_numpy(st.transpose(1, 2, 0).reshape(4 * K, M).copy()),
        torch.from_numpy(x.T.copy()))
    np.testing.assert_array_equal(got_y.numpy().T, np.asarray(want_y))
    np.testing.assert_array_equal(
        got_st.numpy().reshape(K, 4, M).transpose(2, 0, 1),
        np.asarray(want_st))
    six = torch.from_numpy(np.concatenate([aa, aa[:1]]))
    with pytest.raises(ValueError, match=r"1\.\.5 sections"):
        cuda_biquad.cascade(six, torch.zeros(24, M), torch.zeros(T, M))


def _k5_starts(L, W):
    """Every residue mod 4 in range, negative, past L - W and below -L."""
    starts = []
    for r in range(4):
        starts += [4 * 7 + r, 4 * 90 + r, -(4 * 5 + r), -(L - 4 * 2 - r),
                   L - W + 1 + r, 4 * 500 + r, -(L + 4 * 3 + r)]
    return np.array(starts)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_k5_twin_matches_dynamic_slice_for_int32_and_int64(dtype):
    L, W = 864, 480
    start = _k5_starts(L, W).astype(dtype)
    buf = np.random.default_rng(4).standard_normal(
        (start.size, L)).astype(np.float32)
    want = jax.jit(jax.vmap(
        lambda b, s: jax.lax.dynamic_slice(b, (s,), (W,))))(
            buf, start.astype(np.int32))
    got = cuda_window.take_windows(torch.from_numpy(buf),
                                   torch.from_numpy(start), W)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert {int(s) % 4 for s in start} == {0, 1, 2, 3}


@pytest.mark.parametrize("take", ["cpu", "cuda_wrapper"])
def test_window_and_span_wrappers_refuse_other_dtypes(take):
    """The CPU path checks before the twin; the CUDA wrapper checks before
    it touches the kernel library."""
    k5 = {"cpu": cuda_window.take_windows,
          "cuda_wrapper": cuda_window.take_windows_cuda}[take]
    k2 = {"cpu": cuda_span.span_gather,
          "cuda_wrapper": cuda_span.span_gather_cuda}[take]
    buf, ring = torch.zeros(4, 864), torch.zeros(4, 20, 6)
    ints = torch.zeros(4, dtype=torch.int64)
    for start in (torch.zeros(4), torch.zeros(4, dtype=torch.float64),
                  torch.zeros(4, dtype=torch.bool)):
        with pytest.raises(TypeError, match="start"):
            k5(buf, start, 480)
        with pytest.raises(TypeError, match="start"):
            k2(ring, start, 3)
    for dtype in (torch.float64, torch.float16, torch.int32):
        with pytest.raises(TypeError, match="buf"):
            k5(buf.to(dtype), ints, 480)
        with pytest.raises(TypeError, match="ring"):
            k2(ring.to(dtype), ints, 3)


@pytest.mark.parametrize("take", ["cpu", "cuda_wrapper"])
def test_matched_filter_wrapper_refuses_other_dtypes(take):
    """K3 reads its read index as int32, as the render buffer keeps it
    (``render_buffer.lr_read_index``): any other index type, and data that
    is not float32, raise before the twin or the kernel library."""
    k3 = {"cpu": cuda_matched_filter.nlms,
          "cuda_wrapper": cuda_matched_filter.nlms_cuda}[take]
    kw = dict(shift=384, ds_size=2448, threshold=1.0)
    low, h0, y, sm = (torch.zeros(2, 2448), torch.zeros(2, 5, 512),
                      torch.zeros(2, 16), torch.zeros(2))
    for lr in (torch.zeros(2, dtype=torch.int64), torch.zeros(2),
               torch.zeros(2, dtype=torch.bool)):
        with pytest.raises(TypeError, match="lr_read"):
            k3(low, lr, h0, y, sm, **kw)
    lr = torch.zeros(2, dtype=torch.int32)
    for dtype in (torch.float64, torch.float16):
        with pytest.raises(TypeError, match="lowrate"):
            k3(low.to(dtype), lr, h0, y, sm, **kw)
        with pytest.raises(TypeError, match="h0"):
            k3(low, lr, h0.to(dtype), y, sm, **kw)


def _tree(v):
    """K3's butterfly: the pairwise sum over the last axis (32 lanes) at
    distances 16, 8, 4, 2, 1, in float32."""
    for w in (16, 8, 4, 2, 1):
        v = v[..., :w] + v[..., w:2 * w]
    return v[..., 0]


def k3_order(low, lr, h0, y, sm, *, shift, ds_size, threshold):
    """K3's arithmetic in the kernel's order (``csrc/matched_filter.cu``):
    lane l owns taps taps/32 * l + k; per step an FMA chain over the
    lane's taps for h . x and x . x, the tree over lanes, then e, the gate,
    a and the FMA updates of h and of the error sum."""
    B, N, taps = h0.shape
    sub = y.shape[1]
    tpl = taps // 32
    seg_len = sub - 1 + taps
    starts = (lr.astype(np.int64)[:, None] + np.arange(N) * shift) % ds_size
    idx = (starts[..., None] + np.arange(seg_len)) % ds_size
    segs = low[np.arange(B)[:, None, None], idx]
    h = h0.reshape(B, N, 32, tpl).copy()
    err = np.zeros((B, N), np.float32)
    alphas = np.zeros((B, N, sub), np.float32)
    any_gate = np.zeros((B, N), bool)
    thr = np.float32(threshold)
    for i in range(sub):
        x = segs[..., sub - 1 - i: sub - 1 - i + taps].reshape(B, N, 32, tpl)
        hx = np.zeros((B, N, 32), np.float32)
        xx = np.zeros((B, N, 32), np.float32)
        for k in range(tpl):
            hx = exact_fma(h[..., k], x[..., k], hx)
            xx = exact_fma(x[..., k], x[..., k], xx)
        s, x2 = _tree(hx), _tree(xx)
        yi = y[:, i, None]
        gate = (x2 > thr) & (yi < 32000) & (yi > -32000)
        e = yi - s
        a = np.where(gate, (sm[:, None] * e) / np.maximum(x2, np.float32(
            1e-30)), np.float32(0)).astype(np.float32)
        h = exact_fma(a[..., None, None], x, h)
        err = exact_fma(e, e, err)
        alphas[..., i] = a
        any_gate |= gate
    return h.reshape(B, N, taps), alphas, err, any_gate, segs


def k4_order(seg, h0, al, y, acc_rate):
    """K4's arithmetic in the kernel's order (``csrc/pre_echo.cu``): lane l
    owns taps taps/32 * l + k; per step an FMA chain over each chunk's
    (h0 + wex) x, the running prefix over the lane's chunks, the scan of
    the lane totals, d = y - (earlier lanes + prefix), acc += d^2 and
    wex += a x, each as one FMA."""
    B, taps = h0.shape
    sub = y.shape[1]
    cpl = taps // acc_rate // 32
    h = h0.reshape(B, 32, cpl, acc_rate)
    wex = np.zeros_like(h)
    acc = np.zeros((B, 32, cpl), np.float32)
    for i in range(sub):
        x = seg[:, sub - 1 - i: sub - 1 - i + taps].reshape(h.shape)
        hw = h + wex
        part = np.zeros((B, 32, cpl), np.float32)
        run = np.zeros((B, 32), np.float32)
        for m in range(cpl):
            c = np.zeros((B, 32), np.float32)
            for k in range(acc_rate):
                c = exact_fma(hw[..., m, k], x[..., m, k], c)
            run = run + c
            part[..., m] = run
        incl = run
        for off in (1, 2, 4, 8, 16):
            incl = np.concatenate([incl[:, :off], incl[:, off:]
                                   + incl[:, :-off]], axis=1)
        before = np.concatenate([np.zeros((B, 1), np.float32),
                                 incl[:, :-1]], axis=1)
        d = y[:, i, None, None] - (before[..., None] + part)
        acc = exact_fma(d, d, acc)
        wex = exact_fma(al[:, i, None, None, None], x, wex)
    return acc.reshape(B, taps // acc_rate)


def _max_rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / (np.abs(want).max() + 1e-30))


def _k3_order_inputs(taps, sub, seed):
    """Four streams of the matched filter's ring (DS = 2448, 5 filters 384
    apart). Filter 2 of every stream is near convergence: y is its windows
    through a filter h* (plus -60 dB noise) and h0 = h* + 1e-3 h*, so
    e << s there. The threshold sits 1e-4 below the median window's x^2
    (in double), which opens about half the steps; no x^2 lies within
    2e-5 of it, far beyond float rounding of the sums (~1e-6)."""
    rng = np.random.default_rng(seed)
    B, N, shift, ds = 4, 5, 384, 2448
    low = (rng.standard_normal((B, ds)) * 400).astype(np.float32)
    low[1] *= 1.05
    lr = rng.integers(0, ds, B).astype(np.int32)
    h0 = (rng.standard_normal((B, N, taps)) * 0.01).astype(np.float32)
    seg_len = sub - 1 + taps
    starts = (lr[:, None].astype(np.int64) + np.arange(N) * shift) % ds
    segs = low[np.arange(B)[:, None, None],
               (starts[..., None] + np.arange(seg_len)) % ds].astype(
                   np.float64)
    wins = np.stack([segs[..., sub - 1 - i: sub - 1 - i + taps]
                     for i in range(sub)], axis=2)  # (B, N, sub, taps)
    h_star = rng.standard_normal((B, taps)) * 0.05
    y = np.einsum("bst,bt->bs", wins[:, 2], h_star)
    y = (y * (1 + 1e-3 * rng.standard_normal(y.shape))).astype(np.float32)
    h0[:, 2] = (h_star * (1 + 1e-3 * rng.standard_normal(h_star.shape))
                ).astype(np.float32)
    x2 = np.einsum("bnst,bnst->bns", wins, wins)
    thr = float(np.median(x2)) * (1 - 1e-4)
    assert np.abs(x2 / thr - 1).min() > 2e-5
    sm = np.full((B,), 0.7, np.float32)
    return (low, lr, h0, y, sm), thr


@pytest.mark.parametrize("taps,sub", [(512, 16), (256, 8)])
def test_k3_kernel_order_matches_nlms_scan(taps, sub):
    """The kernel's order against ``_nlms_scan`` (jitted, XLA:CPU) within
    2e-5 max-relative on h, alphas and err, ``updated`` and ``segs``
    exact; near-converged filters and gates near the threshold included."""
    args, thr = _k3_order_inputs(taps, sub, seed=taps + sub)
    kw = dict(shift=384, ds_size=2448, threshold=thr)
    want = jax.jit(jax.vmap(functools.partial(
        pallas_mf._nlms_scan, n_filters=5, sub=sub, taps=taps, **kw)))(
            *args)
    got = k3_order(*args, **kw)
    for name, g, w in zip(("h", "alphas", "err"), got[:3], want[:3]):
        assert _max_rel(g, w) <= 2e-5, name
    upd = np.asarray(want[3])
    np.testing.assert_array_equal(got[3], upd)
    np.testing.assert_array_equal(got[4], np.asarray(want[4]))
    # The cases are there: open and shut steps, a converged filter.
    alphas, e_conv = np.asarray(want[1]), np.asarray(want[2])[:, 2]
    assert (alphas == 0).any() and (alphas != 0).any()
    assert e_conv.max() < 1e-3 * np.asarray(want[2]).max()


@pytest.mark.parametrize("taps,acc_rate", [(512, 4), (256, 8), (1024, 1)])
def test_k4_kernel_order_matches_pre_echo_inst_xla(taps, acc_rate):
    """The kernel's order against ``pre_echo_inst_xla`` (jitted, XLA:CPU)
    within 2e-4 after dividing by max(|out|, 1), with a near-converged
    filter: y_i is the full h_i . x_i plus -40 dB noise, so the last
    chunks' errors are small against the sums. (The bar is absolute where
    |out| < 1: at -60 dB and taps 1024 the twin's own order comes within
    1.5e-4 of it.)"""
    rng = np.random.default_rng(taps + acc_rate)
    B, sub = 4, 16
    seg = (rng.standard_normal((B, sub - 1 + taps)) * 100).astype(np.float32)
    h0 = (rng.standard_normal((B, taps)) * 0.1).astype(np.float32)
    al = (rng.standard_normal((B, sub)) * 1e-5).astype(np.float32)
    s64 = seg.astype(np.float64)
    wex = np.zeros((B, taps))
    y = np.zeros((B, sub))
    for i in range(sub):
        x = s64[:, sub - 1 - i: sub - 1 - i + taps]
        y[:, i] = ((h0 + wex) * x).sum(-1)
        wex += al[:, i, None] * x
    y = (y * (1 + 1e-2 * rng.standard_normal(y.shape))).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(functools.partial(
        pallas_pre_echo.pre_echo_inst_xla, sub=sub, taps=taps,
        acc_rate=acc_rate)))(seg, h0, al, y))
    got = k4_order(seg, h0, al, y, acc_rate)
    scale = np.maximum(np.abs(want), 1.0)
    assert np.abs((got - want) / scale).max() <= 2e-4
    assert want[:, -1].max() < 1e-3 * want.max()  # converged at the end


def test_ptxas_lines_name_each_kernel():
    """The ``nvcc -Xptxas -v`` lines kept for the build report: each
    kernel's entry line, then its spills and registers, nothing else."""
    ns = "_ZN50_GLOBAL__N__88497ba4_17_matched_filter_cu_c942890a"
    k3 = ns + "11nlms_kernelILi16ELi16EEEvPKfPKiS2_S2_S2_PfS5_S5_PhS5_iiiifi"
    k4 = ("_ZN44_GLOBAL__N__1be17e9e_11_pre_echo_cu_a8fa75bb23pre_echo_"
          "general_kernelEPKfS1_S1_S1_Pfiii")
    log = "\n".join([
        "ptxas info    : 0 bytes gmem",
        f"ptxas info    : Compiling entry function '{k3}' for 'sm_90a'",
        f"ptxas info    : Function properties for {k3}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 72 registers, used 0 barriers",
        f"ptxas info    : Compiling entry function '{k4}' for 'sm_90a'",
        f"ptxas info    : Function properties for {k4}",
        "    8 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads",
        "ptxas info    : Used 60 registers, used 0 barriers"])
    assert cuda_build.ptxas_lines(log) == [
        f"ptxas info    : Compiling entry function '{k3}' for 'sm_90a'",
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 72 registers, used 0 barriers",
        f"ptxas info    : Compiling entry function '{k4}' for 'sm_90a'",
        "8 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads",
        "ptxas info    : Used 60 registers, used 0 barriers"]
    assert cuda_build.ptxas_lines("") == []

# ------------------------------------------------- K6's 128-point transforms
#
# K6 computes each 128-point real transform as a 64-point complex FFT on one
# warp (lane j holds points j and j + 32, cross-lane butterflies by
# shuffles) and the real split or merge step. The model below follows the
# kernel's order operation for operation (its __fmaf_rn, __fmul_rn,
# __fadd_rn and __fsub_rn), vectorised over the 32 lanes.


def _sincos128():
    """K6's twiddle table: (cos, sin) of 2 pi m / 128, m < 128, in
    float32."""
    m = np.arange(128)
    return (np.cos(2 * np.pi * m / 128).astype(np.float32),
            np.sin(2 * np.pi * m / 128).astype(np.float32))


def _rev5(j):
    return np.array([int(f"{v:05b}"[::-1], 2) for v in np.ravel(j)])


def _stage_twiddle(h):
    """Lane j's twiddle index into the 128-point table at butterfly
    distance h: W64^((j mod h) * 32 / h) = W128^(2 (j mod h) * 32 / h)."""
    j = np.arange(32)
    return 2 * (j & (h - 1)) * (32 // h)


def _f(x):
    return np.asarray(x, np.float32)


def _cmul(vx, vy, c, s, sign):
    """(vx + i vy)(c + i sign s), each part one multiply and one fma."""
    re = exact_fma(vx, c, _f(-sign * _f(vy * s)))
    im = exact_fma(vy, c, _f(sign * _f(vx * s)))
    return re, im


def _xor_lanes(v, h):
    return v[..., np.arange(32) ^ h]


def k6_fft64_forward(z0, z1):
    """Decimation in frequency, forward (W64 = exp(-2 pi i / 64)): lane j's
    points j and j + 32 in (z0, z1) = ((re, im), (re, im)), each (..., 32).
    Returns the lanes' registers: point n holds Z[rev6(n)]."""
    c, s = _sincos128()
    t = 2 * np.arange(32)  # stage 32: W64^j
    (ax, ay), (bx, by) = z0, z1
    z0 = (_f(ax + bx), _f(ay + by))
    z1 = _cmul(_f(ax - bx), _f(ay - by), c[t], s[t], -1)
    upper = None
    for h in (16, 8, 4, 2, 1):
        t = _stage_twiddle(h)
        upper = (np.arange(32) & h) != 0
        regs = []
        for vx, vy in (z0, z1):
            px, py = _xor_lanes(vx, h), _xor_lanes(vy, h)
            bx, by = _cmul(_f(px - vx), _f(py - vy), c[t], s[t], -1)
            regs.append((np.where(upper, bx, _f(vx + px)),
                         np.where(upper, by, _f(vy + py))))
        z0, z1 = regs
    return z0, z1


def k6_rfft(x):
    """rfft of (..., 128) float32 in K6's order -> (re, im) (..., 65)."""
    x = _f(x)
    z0 = (x[..., 0:64:2], x[..., 1:64:2])
    z1 = (x[..., 64::2], x[..., 65::2])
    z0, z1 = k6_fft64_forward(z0, z1)
    # Z in natural order: lane j holds Z[2 rev5(j)] and Z[2 rev5(j) + 1].
    m = _rev5(np.arange(32))
    Zx = np.empty(x.shape[:-1] + (64,), np.float32)
    Zy = np.empty_like(Zx)
    Zx[..., 2 * m], Zy[..., 2 * m] = z0
    Zx[..., 2 * m + 1], Zy[..., 2 * m + 1] = z1
    c, s = _sincos128()
    k = np.arange(65)
    ax, ay = Zx[..., k % 64], Zy[..., k % 64]
    bx, by = Zx[..., (64 - k) % 64], -Zy[..., (64 - k) % 64]  # conj
    sx, sy = _f(ax + bx), _f(ay + by)
    dx, dy = _f(ax - bx), _f(ay - by)
    re = exact_fma(c[k], dy, exact_fma(-s[k], dx, sx))
    im = exact_fma(-c[k], dx, exact_fma(-s[k], dy, sy))
    return _f(0.5 * re), _f(0.5 * im)


def k6_irfft(Xr, Xi):
    """irfft to (..., 128) of 65 bins in K6's order; the imaginary parts of
    bins 0 and 64 are ignored."""
    Xr, Xi = _f(Xr), _f(Xi).copy()
    Xi[..., 0] = 0.0
    Xi[..., 64] = 0.0
    c, s = _sincos128()
    k = np.arange(64)
    ax, ay = Xr[..., k], Xi[..., k]
    bx, by = Xr[..., 64 - k], -Xi[..., 64 - k]  # conj(X[64 - k])
    ex, ey = _f(ax + bx), _f(ay + by)
    dx, dy = _f(ax - bx), _f(ay - by)
    Zx = exact_fma(-dy, c[k], exact_fma(-dx, s[k], ex))
    Zy = exact_fma(dx, c[k], exact_fma(-dy, s[k], ey))
    # Decimation in time, inverse: point n starts with Z[rev6(n)].
    m = 2 * _rev5(np.arange(32))
    z0, z1 = (Zx[..., m], Zy[..., m]), (Zx[..., m + 1], Zy[..., m + 1])
    for h in (1, 2, 4, 8, 16):
        t = _stage_twiddle(h)
        upper = (np.arange(32) & h) != 0
        regs = []
        for vx, vy in (z0, z1):
            tx, ty = _cmul(vx, vy, c[t], s[t], 1)
            sx = np.where(upper, tx, vx)
            sy = np.where(upper, ty, vy)
            px, py = _xor_lanes(sx, h), _xor_lanes(sy, h)
            regs.append((np.where(upper, _f(px - tx), _f(vx + px)),
                         np.where(upper, _f(py - ty), _f(vy + py))))
        z0, z1 = regs
    t = 2 * np.arange(32)
    tx, ty = _cmul(*z1, c[t], s[t], 1)
    lo = (_f(z0[0] + tx), _f(z0[1] + ty))  # z[j]
    hi = (_f(z0[0] - tx), _f(z0[1] - ty))  # z[j + 32]
    out = np.empty(Xr.shape[:-1] + (128,), np.float32)
    scale = np.float32(1 / 128)
    out[..., 0:64:2], out[..., 1:64:2] = lo[0] * scale, lo[1] * scale
    out[..., 64::2], out[..., 65::2] = hi[0] * scale, hi[1] * scale
    return out


HANNING64 = (np.sin(np.pi * np.arange(64) / 63.0) ** 2).astype(np.float32)


def _spectra(rng, shape, scale):
    """Random spectra whose bins 0 and 64 carry imaginary parts too (a
    real inverse ignores them)."""
    return (_f(rng.standard_normal(shape + (65,)) * scale),
            _f(rng.standard_normal(shape + (65,)) * scale))


def _k6_use(use, R, rng):
    """(K6's result in its order, np.fft's in float64) for one use of the
    transforms at R render channels, 16 transforms of each."""
    if use == "prediction_tail":
        # S is the sum of the R render channels' partial products.
        parts = [_spectra(rng, (16,), 3e4) for _ in range(R)]
        Sr, Si = parts[0]
        for pr, pi in parts[1:]:
            Sr, Si = _f(Sr + pr), _f(Si + pi)
        got = k6_irfft(Sr, Si)[..., 64:]
        want = np.fft.irfft(Sr.astype(np.float64) + 1j * Si, 128)[..., 64:]
        return got, want
    if use == "error_forward":
        e = _f(rng.standard_normal((16, R, 64)) * 1e3)
        x = np.concatenate([np.zeros_like(e), _f(HANNING64 * e)], axis=-1)
        got = k6_rfft(x)
        want = np.fft.rfft(x.astype(np.float64), 128)
        return got[0] + 1j * got[1].astype(np.float64), want
    if use == "constrain_head":
        Hr, Hi = _spectra(rng, (16, R), 0.1)
        got = k6_irfft(Hr, Hi)[..., :64]
        want = np.fft.irfft(Hr.astype(np.float64) + 1j * Hi, 128)[..., :64]
        return got, want
    h = _f(rng.standard_normal((16, R, 64)) * 1e-2)
    x = np.concatenate([h, np.zeros_like(h)], axis=-1)
    got = k6_rfft(x)
    want = np.fft.rfft(x.astype(np.float64), 128)
    return got[0] + 1j * got[1].astype(np.float64), want


@pytest.mark.parametrize("R", [1, 2])
@pytest.mark.parametrize("use", ["prediction_tail", "error_forward",
                                 "constrain_head", "constrain_forward"])
def test_k6_transform_order_matches_numpy_fft(use, R):
    """K6's pruned FFT order against np.fft in float64, within 1e-6 of the
    output's scale (a few float32 ulps; the kernel is held to its twin at
    K6_RTOL = 2e-3), for each of its four uses; the inverse ignores the
    imaginary parts of bins 0 and 64."""
    rng = np.random.default_rng(len(use) * 10 + R)
    got, want = _k6_use(use, R, rng)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= 1e-6, err
