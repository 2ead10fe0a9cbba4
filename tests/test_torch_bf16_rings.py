"""AEC3's render rings in bfloat16 (``ring_dtype="bfloat16"``, the JAX
package's serving mode) against the JAX package on the CPU: only the
``blocks`` and ``sf`` rings store bf16, so they take half the bytes; the
rings' bits after inserts and staged flushes equal the JAX package's
(numpy has no bf16: the bridge hands them over as uint16 bit patterns);
every read comes back float32 with the staged float32 rows overlaid, on
the pair path's chain reads and on the per-block path's windows;
``echo_canceller3.process_frame`` at 16 kHz mono, B = 2 streams of a mono
echo scene for 40 frames, within the BASELINE.md bar with the delay equal
on every frame. The JAX steps, one stream each, compile side by side,
once, in the module fixture."""

import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from webrtc_audio_processing_tpu.models.aec3 import (
    config as j_a3cfg,
    echo_canceller3 as j_ec3,
    render_buffer as j_rb,
)

from webrtc_audio_processing_tpu_torch import apm, config as cfg_mod
from webrtc_audio_processing_tpu_torch.models.aec3 import (
    config as a3cfg,
    echo_canceller3 as ec3,
    render_buffer as rb,
)
from webrtc_audio_processing_tpu_torch.ops import cuda_span

from tests.torch_aec3_setup import (
    assert_states_close,
    batched,
    flat,
    mono_scene,
    ordinal,
    rel_rms_per_stream,
    run_aec3_both,
    t,
    torch_tree,
)

B = 2
RATE = 16000
N_FRAMES = 40
STATE_FRAME = 4  # the states are compared after this frame
BF16 = ml_dtypes.bfloat16
RINGS = ("blocks", "sf")


@functools.lru_cache(maxsize=None)
def _geometries(ring_dtype="bfloat16"):
    jcfg, _ = j_a3cfg.validate(j_a3cfg.EchoCanceller3Config())
    cfg, _ = a3cfg.validate(a3cfg.EchoCanceller3Config())
    return (j_ec3.Aec3Geometry.create(jcfg, RATE, 1, 1,
                                      ring_dtype=ring_dtype),
            ec3.Aec3Geometry.create(cfg, RATE, 1, 1, ring_dtype=ring_dtype))


@pytest.fixture(scope="module")
def runs():
    jgeo, geo = _geometries()
    renders, captures = mono_scene(N_FRAMES, B, seed=13, delay=480)
    return run_aec3_both(jgeo, geo, renders, captures, (STATE_FRAME,))


def _bits(x):
    """A bf16 leaf's bit patterns: JAX's ml_dtypes array or the port's
    uint16 view."""
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype == BF16 else x


def _as_float(bits):
    return (bits.astype(np.uint32) << 16).view(np.float32)


def assert_within_one_bf16_step(got_bits, want_bits):
    """bf16 values from float32 values that differ by float ulps: each
    within one bf16 step (2**-7 of its magnitude) of the other, or within
    1e-6 of the leaf's scale (the sign of a value that is zero in exact
    arithmetic)."""
    got, want = _as_float(got_bits), _as_float(want_bits)
    scale = float(np.abs(want).max())
    assert (np.abs(got - want)
            <= 2.0 ** -7 * np.abs(want) + 1e-6 * scale).all()


def test_only_the_two_rings_are_bf16_and_take_half_the_bytes():
    """The blocks and sf rings in bf16, the staging rows, the low-rate
    ring and everything else float32 (the JAX package's
    render_buffer.py:442-451): the two rings' bytes a stream are exactly
    half the float32 rings' (tests/test_bf16_rings.py:67-75), and the
    port's leaves have the JAX package's dtypes."""
    jgeo, geo = _geometries()
    _, geo32 = _geometries("float32")
    s16 = ec3.init_state(geo, 1, "cpu").buffer
    s32 = ec3.init_state(geo32, 1, "cpu").buffer
    bytes16 = sum(getattr(s16, k).nbytes for k in RINGS)
    bytes32 = sum(getattr(s32, k).nbytes for k in RINGS)
    assert 2 * bytes16 == bytes32
    assert geo.buffer.ring_torch_dtype == torch.bfloat16
    want = flat(j_rb.init_state(jgeo.buffer, jgeo.config))
    got = apm.state_to_numpy(s16)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == (np.uint16 if v.dtype == BF16 else v.dtype), k
    assert {k for k, v in want.items() if v.dtype == BF16} == set(RINGS)


def test_ring_dtype_is_float32_or_bfloat16():
    """The port takes the two dtypes it serves; any other name raises
    ValueError naming them (the JAX package takes any dtype string)."""
    cfg = a3cfg.EchoCanceller3Config()
    for name in ("float16", "float64", "bf16"):
        with pytest.raises(ValueError, match="'float32' or 'bfloat16'"):
            ec3.Aec3Geometry.create(cfg, RATE, 1, 1, ring_dtype=name)
        with pytest.raises(ValueError, match="'float32' or 'bfloat16'"):
            apm.ApmGeometry.create(cfg_mod.Config(), RATE,
                                   aec3_ring_dtype=name)


@functools.lru_cache(maxsize=None)
def _jax_buffer_ops():
    """The JAX render buffer's staged insert (one jit a slot) and flush,
    batched, compiled once for the file."""
    jgeo, _ = _geometries()
    insert = {slot: jax.jit(jax.vmap(
        lambda s, blk, n, slot=slot: j_rb.insert(
            jgeo.buffer, jgeo.config, s, blk, n, sf_slot=slot),
        in_axes=(0, 0, None))) for slot in range(5)}
    flush = jax.jit(jax.vmap(lambda s, n: j_rb.flush_sf_pending(
        jgeo.buffer, s, n), in_axes=(0, None)))
    return insert, flush


CADENCE_F0, CADENCE_FRAMES = 63, 7  # n0 = 157 ..: the writes wrap the ring


@pytest.fixture(scope="module")
def cadence():
    """Seven frames of the paired cadence (three flushes, the last frame
    odd: 5 rows staged) from a JAX bf16 state in mid-stream (random ring
    rows, so the flushes overwrite values of both signs and scales), both
    packages: (JAX state, the port's state flattened, the last insert's
    ordinal)."""
    jgeo, geo = _geometries()
    insert, flush = _jax_buffer_ops()
    rng = np.random.default_rng(21)
    js = batched(j_rb.init_state(jgeo.buffer, jgeo.config), B)
    js = js.replace(
        sf=(rng.standard_normal(js.sf.shape) * 1e4).astype(BF16),
        blocks=(rng.standard_normal(js.blocks.shape) * 1e3).astype(BF16),
        b_delay=rng.integers(1, 40, B).astype(np.int32),
        lr_latency=(16 * rng.integers(1, 40, B)).astype(np.int32))
    state = torch_tree(rb.init_state(geo.buffer, geo.config, B, "cpu"), js)
    for f in range(CADENCE_F0, CADENCE_F0 + CADENCE_FRAMES):
        parity, n0 = f % 2, 5 * (f // 2) + 2 * (f % 2)
        if parity == 0:
            js = flush(js, jnp.int32(n0))
            state = rb.flush_sf_pending(geo.buffer, state, ordinal(n0))
        base = 0 if parity == 0 else 2
        for k in range(2 + parity):
            blk = (rng.standard_normal((B, 1, 64, 1)) * 3000).astype(
                np.float32)
            js, _ = insert[base + k](js, blk, jnp.int32(n0 + k + 1))
            state, _ = rb.insert(geo.buffer, geo.config, state, t(blk),
                                 ordinal(n0 + k + 1), sf_slot=base + k)
    return (js, apm.state_to_numpy(state),
            apm.block_ordinal(CADENCE_F0 + CADENCE_FRAMES))


def test_ring_bits_after_inserts_and_flushes_match_jax(cadence):
    """After the cadence (each flush rounding the pair's staged float32
    rows to bf16, to nearest even): every bit of the blocks ring equals
    JAX's; the sf ring's rows hold the FFT planes and spectra, which
    jnp.fft and torch.fft round differently by ~1 float ulp, so its bits
    equal JAX's where the staged float32 values agree (over 99% of them)
    and are one bf16 step apart at most elsewhere; the rest of the state
    as the float32 rings' test holds it. Then a flush from one state, both
    packages: every bit of both rings equal."""
    js, got, n = cadence
    want = flat(js)
    assert got["blocks"].dtype == np.uint16
    np.testing.assert_array_equal(got["blocks"], _bits(want["blocks"]))
    assert_within_one_bf16_step(got["sf"], _bits(want["sf"]))
    assert (got["sf"] == _bits(want["sf"])).mean() > 0.99
    rest = [k for k in want if k not in RINGS + ("sf_pending",)]
    assert_states_close({k: got[k] for k in rest}, {k: want[k] for k in rest},
                        rtol=0.0)

    _, geo = _geometries()
    state = torch_tree(rb.init_state(geo.buffer, geo.config, B, "cpu"), js)
    js = _jax_buffer_ops()[1](js, jnp.int32(n))
    state = rb.flush_sf_pending(geo.buffer, state, ordinal(n))
    got = apm.state_to_numpy(state)
    for k in RINGS:
        np.testing.assert_array_equal(got[k], _bits(flat(js)[k]), err_msg=k)


@pytest.mark.parametrize("path", ["pair", "per_block"])
def test_reads_overlay_the_staged_float32_rows(cadence, path):
    """On the cadence's bf16 state with its 5 staged rows (the JAX state,
    both packages), every read bit for bit, as float32, for each pending
    count: the pair path's chain reads (``sf_span`` and ``blocks_span`` at
    any start) and the per-block path's windows (``sf_window``,
    ``block_window_back``, ``spectrum_at``). A row still staged reads back
    unrounded, a flushed one rounded."""
    jgeo, geo = _geometries()
    js, _, n = cadence
    rng = np.random.default_rng(22)
    state = torch_tree(rb.init_state(geo.buffer, geo.config, B, "cpu"), js)
    jg = jgeo.buffer
    for pending in (0, 2, 5):
        view = rb.RenderView(state, ordinal(n), pending)

        def jview(st, p=pending):
            return j_rb.RenderView(st, jnp.int32(n), p)

        if path == "pair":
            starts = rng.integers(0, geo.buffer.num_blocks, B).astype(
                np.int32)
            reads = [
                (rb.sf_span(geo.buffer, view, t(starts), 17),
                 jax.vmap(lambda st, s: j_rb.sf_span(jg, jview(st), s, 17))(
                     js, starts)),
                (rb.blocks_span(geo.buffer, view, t(starts), 13),
                 jax.vmap(lambda st, s: j_rb.blocks_span(
                     jg, jview(st), s, 13))(js, starts))]
        else:
            reads = [
                (rb.sf_window(geo.buffer, view, 15),
                 jax.vmap(lambda st: j_rb.sf_window(jg, jview(st), 15))(js)),
                (rb.block_window_back(geo.buffer, view, 13),
                 jax.vmap(lambda st: j_rb.block_window_back(
                     jg, jview(st), 13))(js)),
                (rb.spectrum_at(geo.buffer, view, 1),
                 jax.vmap(lambda st: j_rb.spectrum_at(jg, jview(st), 1))(js))]
        for got, want in reads:
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # A staged row overlays the ring's (older, rounded) row.
    staged = rb.sf_span(geo.buffer, rb.RenderView(state, ordinal(n), 5),
                        rb.s_write_index(geo.buffer, ordinal(n)).expand(B), 1)
    assert torch.equal(staged[:, 0], state.sf_pending[:, 4])


def test_k2_twin_reads_bf16_as_float32():
    """K2's twin on a bf16 ring: the gather in bf16, then float32, so each
    value is the bf16 bits as the high half of the float."""
    rng = np.random.default_rng(23)
    ring = torch.from_numpy(rng.standard_normal((3, 40, 24)).astype(
        np.float32)).to(torch.bfloat16)
    start = torch.tensor([0, 17, -5], dtype=torch.int32)
    got = cuda_span.span_gather(ring, start, 9)
    assert got.dtype == torch.float32
    bits = ring.view(torch.int16).numpy().view(np.uint16)
    for b, s in enumerate((0, 17, 31)):  # -5 counts from the end, clamped
        np.testing.assert_array_equal(got[b].numpy(),
                                      _as_float(bits[b, s:s + 9]))


def test_bridge_hands_bf16_leaves_over_as_uint16(runs):
    """``state_to_numpy`` gives a bf16 leaf as its uint16 bit patterns, and
    ``tree_to_state`` takes them back, as it takes JAX's ml_dtypes
    arrays."""
    js = runs["jax_tree"][STATE_FRAME]
    _, geo = _geometries()
    template = ec3.init_state(geo, B, "cpu")
    from_jax = torch_tree(template, js)
    assert from_jax.buffer.sf.dtype == torch.bfloat16
    flat_port = apm.state_to_numpy(from_jax)
    np.testing.assert_array_equal(flat_port["buffer.sf"],
                                  _bits(flat(js)["buffer.sf"]))
    back = apm.tree_to_state(template, js.replace(buffer=js.buffer.replace(
        sf=flat_port["buffer.sf"], blocks=flat_port["buffer.blocks"])))
    assert torch.equal(back.buffer.sf.view(torch.int16),
                       from_jax.buffer.sf.view(torch.int16))


def test_output_matches_jax_within_relative_rms(runs):
    """40 frames with bf16 rings: relative RMS <= 1e-3 per stream (the
    BASELINE.md bar), finite."""
    got, want = runs["torch"], runs["jax"]
    assert got.shape == want.shape == (N_FRAMES, B, 1, 160, 1)
    assert np.isfinite(got).all()
    rel = rel_rms_per_stream(got, want)
    assert (rel <= 1e-3).all(), rel


def test_delay_equal_on_every_frame(runs):
    np.testing.assert_array_equal(runs["torch_delay"], runs["jax_delay"])


def test_state_matches_jax_a_few_frames_in(runs):
    """Every leaf of AEC3's state after frame 4: the blocks ring's bits
    equal; the sf ring within one bf16 step (its FFT rows differ by float
    ulps before the rounding); the other integer and boolean
    leaves exact, the float ones within 1e-4 of each leaf's scale
    (tests/test_torch_apm_16k_mono.py's bar)."""
    got = runs["torch_state"][STATE_FRAME]
    want = runs["jax_state"][STATE_FRAME]
    np.testing.assert_array_equal(got["buffer.blocks"],
                                  _bits(want["buffer.blocks"]))
    assert_within_one_bf16_step(got["buffer.sf"], _bits(want["buffer.sf"]))
    rings = {f"buffer.{k}" for k in RINGS}
    assert_states_close({k: v for k, v in got.items() if k not in rings},
                        {k: v for k, v in want.items() if k not in rings},
                        rtol=1e-4)
