"""Render-side buffering for AEC3: decimator, alignment mixer, delay buffer.

Port of ``webrtc_audio_processing_tpu/models/aec3/render_buffer.py``
(reference: aec3/decimator.cc, aec3/alignment_mixer.cc,
aec3/render_delay_buffer.cc and its block, spectrum, FFT and downsampled
ring buffers).

The ring layout is the JAX package's, so that ``apm.state_from_jax`` maps
it leaf by leaf and K2 keeps its contract:

* the write positions are functions of the global insert ordinal ``n``
  alone, a 0-d int32 tensor on the state's device uniform across the batch
  (the JAX package's unbatched traced scalar), so every write lands at one
  row for all streams and no position is a Python int (a captured CUDA
  graph replays with the ordinal it finds on the device); per stream only
  the read-side distances ``b_delay`` and ``lr_latency`` are kept;
* the rings are flat rows ``(L + pad + RING_SLACK, F)``: rows [L, L + pad)
  mirror rows [0, pad), so every window read is one contiguous span (K2,
  ``ops/cuda_span.py``); the FFT planes and the spectrum share one row,
  ``[re | im | spectrum | 0]``;
* the rows of one frame pair are staged in ``sf_pending`` and
  ``blocks_pending`` and written into the rings at the start of the next
  pair (``flush_sf_pending``); readers overlay the staged rows;
* with ``ring_dtype="bfloat16"`` the ``blocks`` and ``sf`` rings store
  bf16 (the JAX package's serving mode: half the per-stream ring bytes).
  The staging rows and the low-rate ring stay float32; a flush rounds the
  staged rows to nearest even, and every read comes back as float32 (K2's
  bf16 form upcasts), with the staged rows overlaid in float32, so a row
  still staged reads back unrounded and a flushed one rounded, in the JAX
  package's order.

The rings are updated in place: a state passed to ``insert`` or
``flush_sf_pending`` is changed. Everything else returns new tensors.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from webrtc_audio_processing_tpu_torch.models.aec3 import fft as aec3_fft
from webrtc_audio_processing_tpu_torch.models.aec3.config import (
    EchoCanceller3Config,
)
from webrtc_audio_processing_tpu_torch.ops import biquad, cuda_span
from webrtc_audio_processing_tpu_torch.ops.batch import take

BLOCK_SIZE = 64
NUM_BINS = 65
NUM_BLOCKS_PER_SECOND = 250
MATCHED_FILTER_WINDOW_SUB_BLOCKS = 32
MATCHED_FILTER_SHIFT_SUB_BLOCKS = 24

# Decimator coefficient tables (decimator.cc:22-52).
_LOW_PASS_DS4_B = np.array(
    [[0.0180919877, 0.00320961363, 0.0180919877],
     [1.0, -1.24550459, 1.0],
     [1.0, -1.4221681, 1.0]], np.float32)
_LOW_PASS_DS4_A = np.array(
    [[-1.5183195, 0.633165865],
     [-1.49784254, 0.853586692],
     [-1.49791282, 0.969572384]], np.float32)
_BAND_PASS_DS8_B = np.tile(
    np.array([[0.103304783, 0.0, -0.103304783]], np.float32), (5, 1))
_BAND_PASS_DS8_A = np.tile(
    np.array([[-1.520363, 0.793390435]], np.float32), (5, 1))
_HIGH_PASS_B = np.array([[0.757076375, -1.51415275, 0.757076375]], np.float32)
_HIGH_PASS_A = np.array([[-1.45424359, 0.574061915]], np.float32)

EVENT_NONE = 0
EVENT_RENDER_OVERRUN = 1
EVENT_RENDER_UNDERRUN = 2

# Blocks per frame pair at the 16 kHz band rate: 2 on the even frame and 3
# on the odd one, the size of the write-behind staging.
PAIR_BLOCKS = 5

# Scratch rows past the mirror region (the grouped write's second write
# lands here when neither the mirror nor the wrap case applies). Never read.
RING_SLACK = 8


def get_down_sampled_buffer_size(down_sampling_factor, num_filters):
    """GetDownSampledBufferSize (aec3_common.h:73-78)."""
    return (BLOCK_SIZE // down_sampling_factor) * (
        MATCHED_FILTER_SHIFT_SUB_BLOCKS * num_filters
        + MATCHED_FILTER_WINDOW_SUB_BLOCKS + 1)


def get_render_delay_buffer_size(down_sampling_factor, num_filters,
                                 filter_length_blocks):
    """GetRenderDelayBufferSize (aec3_common.h:80-87)."""
    return (get_down_sampled_buffer_size(down_sampling_factor, num_filters)
            // (BLOCK_SIZE // down_sampling_factor)
            + filter_length_blocks + 1)


def aligned_rows(W: int) -> int:
    """The JAX package's span-read row count for width W
    (``pallas_span.aligned_rows``); it sizes the mirror."""
    return ((W + 7 + 7) // 8) * 8


def decimator_coeffs(down_sampling_factor: int = 4):
    """The decimator's anti-aliasing and noise-reduction cascades as packed
    (K, 5) coefficient arrays (decimator.cc:22-52, :58-71): at factor 4 the
    three-section low-pass and the one-section high-pass, at factor 8 the
    five-section band-pass and no high-pass ((0, 5))."""
    if down_sampling_factor == 8:
        return (biquad.pack_coeffs(_BAND_PASS_DS8_B, _BAND_PASS_DS8_A),
                np.zeros((0, 5), np.float32))
    aa = biquad.pack_coeffs(_LOW_PASS_DS4_B, _LOW_PASS_DS4_A)
    return aa, biquad.pack_coeffs(_HIGH_PASS_B, _HIGH_PASS_A)


def decimator_sections(down_sampling_factor: int) -> tuple[int, int]:
    """The (anti-aliasing, noise-reduction) section counts of a factor's
    decimator state."""
    return tuple(c.shape[0] for c in decimator_coeffs(down_sampling_factor))


@functools.lru_cache(maxsize=None)
def _decimator_tensor(down_sampling_factor: int,
                      device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.concatenate(
        decimator_coeffs(down_sampling_factor))).to(device)


def decimate(down_sampling_factor: int, aa: biquad.BiquadCascadeState,
             nr: biquad.BiquadCascadeState, x: torch.Tensor):
    """Decimator::Decimate (decimator.cc:74-91) on x (B, 64): the
    anti-aliasing cascade, then the noise-reduction high-pass (factor 4
    only), then every ``factor``-th sample. Both cascades run as one launch
    of K1, 4 sections at factor 4 and 5 at factor 8: the sections run in
    sequence per sample either way, so the output is the same. Returns
    (aa, nr, (B, 64 // factor))."""
    k_aa = aa.x.shape[1]
    st = biquad.BiquadCascadeState(x=torch.cat([aa.x, nr.x], dim=1),
                                   y=torch.cat([aa.y, nr.y], dim=1))
    st, y = biquad.process(_decimator_tensor(down_sampling_factor, x.device),
                           st, x)
    aa = biquad.BiquadCascadeState(x=st.x[:, :k_aa], y=st.y[:, :k_aa])
    nr = biquad.BiquadCascadeState(x=st.x[:, k_aa:], y=st.y[:, k_aa:])
    return aa, nr, y[:, ::down_sampling_factor]


# The rings' storage dtypes by name (``ring_dtype``).
RING_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def ring_torch_dtype(name: str) -> torch.dtype:
    """The ring dtype ``name`` as a torch dtype. The JAX package takes any
    dtype string; the port takes the two it serves and raises ValueError
    for any other."""
    if name not in RING_DTYPES:
        raise ValueError(f"AEC3 ring dtype {name!r}: the rings store "
                         f"{' or '.join(map(repr, RING_DTYPES))}")
    return RING_DTYPES[name]


@dataclass(frozen=True)
class BufferGeometry:
    """Static geometry derived from the config."""

    num_bands: int
    num_channels: int
    down_sampling_factor: int
    sub_block_size: int
    num_blocks: int  # L: block/spectrum/fft ring length
    ds_size: int  # low-rate ring length (samples)
    buffer_headroom: int  # refined filter length
    pad: int = 0  # mirror rows: rows [L, L + pad) copy rows [0, pad)
    ring_dtype: str = "float32"  # the blocks and sf rings' storage

    @staticmethod
    def create(config: EchoCanceller3Config, sample_rate_hz: int,
               num_channels: int,
               ring_dtype: str = "float32") -> "BufferGeometry":
        ring_torch_dtype(ring_dtype)
        ds = config.delay.down_sampling_factor
        num_blocks = get_render_delay_buffer_size(
            ds, config.delay.num_filters, config.filter.refined.length_blocks)
        # The widest contiguous window any reader takes (the JAX
        # package's formula); pad = that width's aligned span.
        p_ref_max = max(config.filter.refined.length_blocks,
                        config.filter.refined_initial.length_blocks)
        p_coarse_max = max(config.filter.coarse.length_blocks,
                           config.filter.coarse_initial.length_blocks)
        headroom_blocks = int(config.delay.delay_headroom_samples) // BLOCK_SIZE
        delay_bound = max(config.filter.refined.length_blocks,
                          headroom_blocks + 1)
        spec_win_len = min(
            max(p_ref_max, delay_bound + 2)
            + max(config.echo_model.render_post_window_size, 1) + 1,
            num_blocks)
        max_w = max(spec_win_len + 2, min(delay_bound, num_blocks) + 2,
                    p_ref_max, p_coarse_max, 13)
        lp = max(((num_blocks - 1) // 8) * 8 + aligned_rows(max_w),
                 num_blocks)
        return BufferGeometry(
            num_bands=sample_rate_hz // 16000,
            num_channels=num_channels,
            down_sampling_factor=ds,
            sub_block_size=BLOCK_SIZE // ds,
            num_blocks=num_blocks,
            ds_size=get_down_sampled_buffer_size(ds, config.delay.num_filters),
            buffer_headroom=config.filter.refined.length_blocks,
            ring_dtype=ring_dtype,
            pad=min(lp - num_blocks, num_blocks),
        )

    @property
    def ring_torch_dtype(self) -> torch.dtype:
        return RING_DTYPES[self.ring_dtype]

    @property
    def max_delay(self) -> int:
        return self.num_blocks - 1 - self.buffer_headroom

    @property
    def rows(self) -> int:
        return self.num_blocks + self.pad + RING_SLACK

    @property
    def block_row_shape(self) -> tuple:
        return (self.num_bands, BLOCK_SIZE, self.num_channels)

    @property
    def spec_row_shape(self) -> tuple:
        return (self.num_channels, NUM_BINS)

    @property
    def blocks_row_f(self) -> int:
        return self.num_bands * BLOCK_SIZE * self.num_channels

    @property
    def blocks_row_fp(self) -> int:
        return ((self.blocks_row_f + 127) // 128) * 128

    @property
    def fft_row_f(self) -> int:
        return 2 * self.num_channels * NUM_BINS

    @property
    def spec_row_f(self) -> int:
        return self.num_channels * NUM_BINS

    @property
    def sf_row_fp(self) -> int:
        return ((self.fft_row_f + self.spec_row_f + 127) // 128) * 128


@dataclass
class AlignmentMixerState:
    """AlignmentMixer adaptive-selection state (alignment_mixer.cc:56-160)."""

    strong_block_counters: torch.Tensor  # (B, 2) int32
    cumulative_energies: torch.Tensor  # (B, C)
    block_counter: torch.Tensor  # (B,) int32
    selected_channel: torch.Tensor  # (B,) int32


def init_mixer(batch: int, num_channels: int, device) -> AlignmentMixerState:
    i32 = dict(dtype=torch.int32, device=device)
    return AlignmentMixerState(
        strong_block_counters=torch.zeros((batch, 2), **i32),
        cumulative_energies=torch.zeros((batch, num_channels),
                                        dtype=torch.float32, device=device),
        block_counter=torch.zeros((batch,), **i32),
        selected_channel=torch.zeros((batch,), **i32),
    )


@dataclass
class RenderDelayBufferState:
    blocks: torch.Tensor  # (B, rows, blocks_row_fp) flat rows
    sf: torch.Tensor  # (B, rows, sf_row_fp): [fft re | fft im | spectrum | 0]
    sf_pending: torch.Tensor  # (B, 5, sf_row_fp) staged rows of the pair
    blocks_pending: torch.Tensor  # (B, 5, blocks_row_fp)
    lowrate: torch.Tensor  # (B, DS)
    b_delay: torch.Tensor  # (B,) int32: (b_write - b_read) mod L
    lr_latency: torch.Tensor  # (B,) int32: (lr_read - lr_write) mod DS
    prev_band0: torch.Tensor  # (B, C, 64) last inserted band-0 block
    delay: torch.Tensor  # (B,) int32 (valid when has_delay)
    has_delay: torch.Tensor  # (B,) bool
    render_activity: torch.Tensor  # (B,) bool
    render_activity_counter: torch.Tensor  # (B,) int32
    min_latency_blocks: torch.Tensor  # (B,) int32
    excess_render_detection_counter: torch.Tensor  # (B,) int32
    mixer: AlignmentMixerState
    decimator_aa: biquad.BiquadCascadeState  # anti-aliasing filter
    decimator_nr: biquad.BiquadCascadeState  # noise-reduction filter

    def replace(self, **kw) -> "RenderDelayBufferState":
        return dataclasses.replace(self, **kw)


# Write positions after n inserts (render_delay_buffer.cc:438-443):
#   b_write(n)  =  n mod L,  s_write(n) = -n mod L,
#   lr_write(n) = -n * sub mod DS.
# Read positions: b_read = b_write - b_delay, s_read = s_write + b_delay,
# lr_read = lr_write + lr_latency (all mod their ring length). ``n`` is the
# 0-d int32 ordinal tensor; every position is a tensor on its device.


def b_write_index(geo: BufferGeometry, n: torch.Tensor) -> torch.Tensor:
    return torch.remainder(n, geo.num_blocks)


def s_write_index(geo: BufferGeometry, n: torch.Tensor) -> torch.Tensor:
    return torch.remainder(-n, geo.num_blocks)


def lr_write_index(geo: BufferGeometry, n: torch.Tensor) -> torch.Tensor:
    return torch.remainder(-n * geo.sub_block_size, geo.ds_size)


def s_read_index(geo: BufferGeometry, state, n: torch.Tensor) -> torch.Tensor:
    return torch.remainder(state.b_delay - n, geo.num_blocks)


def b_read_index(geo: BufferGeometry, state, n: torch.Tensor) -> torch.Tensor:
    return torch.remainder(n - state.b_delay, geo.num_blocks)


def lr_read_index(geo: BufferGeometry, state,
                  n: torch.Tensor) -> torch.Tensor:
    return torch.remainder(state.lr_latency - n * geo.sub_block_size,
                           geo.ds_size)


def init_state(geo: BufferGeometry, config: EchoCanceller3Config,
               batch: int, device) -> RenderDelayBufferState:
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    ring = dict(dtype=geo.ring_torch_dtype, device=device)
    b = batch
    aa_sections, nr_sections = decimator_sections(geo.down_sampling_factor)
    state = RenderDelayBufferState(
        blocks=torch.zeros((b, geo.rows, geo.blocks_row_fp), **ring),
        sf=torch.zeros((b, geo.rows, geo.sf_row_fp), **ring),
        sf_pending=torch.zeros((b, PAIR_BLOCKS, geo.sf_row_fp), **f32),
        blocks_pending=torch.zeros((b, PAIR_BLOCKS, geo.blocks_row_fp),
                                   **f32),
        lowrate=torch.zeros((b, geo.ds_size), **f32),
        b_delay=torch.zeros((b,), **i32),
        lr_latency=torch.zeros((b,), **i32),
        prev_band0=torch.zeros((b, geo.num_channels, BLOCK_SIZE), **f32),
        delay=torch.full((b,), config.delay.default_delay, **i32),
        has_delay=torch.zeros((b,), dtype=torch.bool, device=device),
        render_activity=torch.zeros((b,), dtype=torch.bool, device=device),
        render_activity_counter=torch.zeros((b,), **i32),
        min_latency_blocks=torch.zeros((b,), **i32),
        excess_render_detection_counter=torch.zeros((b,), **i32),
        mixer=init_mixer(b, geo.num_channels, device),
        decimator_aa=biquad.init_state(aa_sections, b, None, device),
        decimator_nr=biquad.init_state(nr_sections, b, None, device),
    )
    return reset(geo, config, state)


def reset(geo: BufferGeometry, config: EchoCanceller3Config,
          state: RenderDelayBufferState) -> RenderDelayBufferState:
    """RenderDelayBufferImpl::Reset (render_delay_buffer.cc:148-186): the
    read-side distances only; the write positions never rewind."""
    z = torch.zeros_like(state.b_delay)
    return state.replace(
        min_latency_blocks=z,
        excess_render_detection_counter=z,
        lr_latency=z + geo.sub_block_size,
        b_delay=z + config.delay.default_delay,
        has_delay=torch.zeros_like(state.has_delay),
    )


def alignment_mix(config_mixing, mixer: AlignmentMixerState,
                  band0: torch.Tensor):
    """AlignmentMixer::ProduceOutput (alignment_mixer.cc:63-160).

    band0: (B, C, 64). Returns (new_mixer_state, (B, 64) mono signal)."""
    num_channels = band0.shape[1]
    if num_channels == 1:
        return mixer, band0[:, 0]
    if config_mixing.downmix:
        return mixer, torch.mean(band0, dim=1)
    if not config_mixing.adaptive_selection:
        return mixer, band0[:, 0]

    # Adaptive channel selection (SelectChannel, :97-160).
    dev = band0.device
    threshold = BLOCK_SIZE * config_mixing.activity_power_threshold
    blocks_lr = NUM_BLOCKS_PER_SECOND // 2
    good_lr = (
        (mixer.strong_block_counters[:, 0] > blocks_lr)
        | (mixer.strong_block_counters[:, 1] > blocks_lr))  # (B,)
    if not config_mixing.prefer_first_two_channels:
        good_lr = torch.zeros_like(good_lr)
    x2 = torch.sum(band0 ** 2, dim=-1)  # (B, C)
    first_two = torch.arange(num_channels, device=dev) < 2
    analyze = first_two[None, :] | ~good_lr[:, None]  # (B, C)

    block_counter = mixer.block_counter + 1
    strong = ((x2[:, :2] > threshold) & analyze[:, :2]).to(torch.int32)
    strong_counters = mixer.strong_block_counters + strong

    smooth_after = 60 * NUM_BLOCKS_PER_SECOND
    cum0 = mixer.cumulative_energies
    early = (block_counter <= smooth_after)[:, None]
    cum = torch.where(
        analyze,
        torch.where(early, cum0 + x2,
                    cum0 + (1.0 / (10 * NUM_BLOCKS_PER_SECOND)) * (x2 - cum0)),
        cum0)
    cum = torch.where((block_counter == smooth_after)[:, None] & analyze,
                      cum * (1.0 / smooth_after), cum)

    masked = torch.where(analyze, cum, -float("inf"))
    strongest = torch.argmax(masked, dim=1)
    switch = (good_lr & (mixer.selected_channel > 1)) | (
        take(cum, strongest) > 2.0 * take(cum, mixer.selected_channel))
    selected = torch.where(switch, strongest,
                           mixer.selected_channel.to(torch.int64))
    new_mixer = AlignmentMixerState(
        strong_block_counters=strong_counters.to(torch.int32),
        cumulative_energies=cum,
        block_counter=block_counter.to(torch.int32),
        selected_channel=selected.to(torch.int32),
    )
    return new_mixer, take(band0, selected)


def write_lowrate(geo: BufferGeometry, lowrate: torch.Tensor,
                  sub_block: torch.Tensor, n: torch.Tensor) -> None:
    """Write ``sub_block`` (B, sub) at samples [lr_write(n), + sub) of the
    low-rate ring (B, DS), in place. DS is a multiple of sub, so the span
    never wraps."""
    idx = lr_write_index(geo, n) + torch.arange(
        geo.sub_block_size, device=lowrate.device)
    lowrate.index_copy_(1, idx, sub_block)


def insert(geo: BufferGeometry, config: EchoCanceller3Config,
           state: RenderDelayBufferState, block: torch.Tensor,
           n: torch.Tensor, sf_slot: int):
    """RenderDelayBufferImpl::Insert (render_delay_buffer.cc:189-231).

    block: (B, bands, 64, C); ``n`` is the post-increment insert ordinal, a
    0-d int32 tensor (the first insert ever passes n = 1). ``sf_slot`` in
    [0, 5) is the block's position in its frame pair (even frame 0-1, odd
    frame 2-4): the block, FFT and spectrum rows are staged there and reach
    the rings at ``flush_sf_pending``. The low-rate ring is written in
    place. Returns (state, event (B,) int32)."""
    if not 0 <= sf_slot < PAIR_BLOCKS:
        raise ValueError(f"sf_slot {sf_slot} outside [0, {PAIR_BLOCKS})")
    B = block.shape[0]
    # IncrementWriteIndices (:438-443) in distance form.
    b_delay = torch.remainder(state.b_delay + 1, geo.num_blocks)
    lr_latency = torch.remainder(state.lr_latency + geo.sub_block_size,
                                 geo.ds_size)
    overrun = (lr_latency == 0) | (b_delay == 0)

    # Render activity detection (:214-218, :415-419).
    x0 = block[:, 0, :, 0]
    active = torch.sum(x0 * x0, dim=1) > (
        config.render_levels.active_render_limit ** 2) * BLOCK_SIZE
    counter = state.render_activity_counter + torch.where(
        state.render_activity, 0, active.to(torch.int32))
    render_activity = state.render_activity | (counter >= 20)

    # InsertBlock (:367-407).
    gain = 10.0 ** (config.render_levels.render_power_gain_db / 20.0)
    if gain != 1.0:
        block = block * gain
    block_row = block.reshape(B, -1)
    state.blocks_pending[:, sf_slot, : geo.blocks_row_f] = block_row

    band0 = block[:, 0].transpose(1, 2)  # (B, C, 64)
    mixer, mono = alignment_mix(config.delay.render_alignment_mixing,
                                state.mixer, band0)
    aa, nr, ds = decimate(geo.down_sampling_factor, state.decimator_aa,
                          state.decimator_nr, mono)
    # The decimated sub-block is stored time-reversed (:389).
    write_lowrate(geo, state.lowrate, torch.flip(ds, dims=[1]), n)

    X = aec3_fft.padded_fft(band0, state.prev_band0)  # (B, C, 65)
    f, s = geo.fft_row_f, geo.spec_row_f
    row = state.sf_pending[:, sf_slot]
    row[:, : f // 2] = X.real.reshape(B, -1)
    row[:, f // 2: f] = X.imag.reshape(B, -1)
    row[:, f: f + s] = aec3_fft.spectrum(X).reshape(B, -1)

    # An overrun resets the read side (:227-229).
    z = torch.zeros_like(b_delay)
    state = state.replace(
        render_activity_counter=counter.to(torch.int32),
        render_activity=render_activity,
        prev_band0=band0,
        mixer=mixer,
        decimator_aa=aa,
        decimator_nr=nr,
        min_latency_blocks=torch.where(overrun, z, state.min_latency_blocks),
        excess_render_detection_counter=torch.where(
            overrun, z, state.excess_render_detection_counter),
        lr_latency=torch.where(overrun, z + geo.sub_block_size,
                               lr_latency).to(torch.int32),
        b_delay=torch.where(overrun, z + config.delay.default_delay,
                            b_delay).to(torch.int32),
        has_delay=state.has_delay & ~overrun,
    )
    event = torch.where(overrun, EVENT_RENDER_OVERRUN,
                        EVENT_NONE).to(torch.int32)
    return state, event


def _ring_write_group(geo: BufferGeometry, buf: torch.Tensor,
                      group: torch.Tensor, start: torch.Tensor) -> None:
    """Write the K rows ``group`` (B, K, F) at ring rows [start, start + K)
    in place, with the JAX package's mirror upkeep (``ring_write_group``),
    branch-free on the 0-d tensor ``start``: the first write goes to rows
    start + [0, K); the second to the mirror rows start + L + [0, K) when
    start < pad, else to rows [0, K) keeping only the wrapped tail [0, t)
    when t = start + K - L > 0, else to the scratch rows L + pad + [0, K).
    Rows the second write does not keep are written back as they are. The
    group is first rounded to the ring's dtype (to nearest even for bf16,
    as the JAX package's ``astype``)."""
    group = group.to(buf.dtype)
    K = group.shape[1]
    L, pad = geo.num_blocks, geo.pad
    if K > pad:
        raise ValueError(f"group of {K} rows exceeds the mirror ({pad})")
    i = torch.arange(K, device=buf.device)
    buf.index_copy_(1, start + i, group)
    t = torch.clamp(start + K - L, min=0)
    mirror = start < pad
    wrap = t > 0
    rows = torch.where(mirror, start + L,
                       torch.where(wrap, 0, L + pad)) + i
    # Row i of a wrapped tail takes group row (i - t) mod K.
    sel = group.index_select(1, torch.where(mirror, i,
                                            torch.remainder(i - t, K)))
    keep = mirror | (i < t) | ~wrap
    buf.index_copy_(1, rows, torch.where(keep[:, None], sel,
                                         buf.index_select(1, rows)))


def flush_sf_pending(geo: BufferGeometry, state: RenderDelayBufferState,
                     n_last: torch.Tensor) -> RenderDelayBufferState:
    """Write the staged rows of the previous frame pair into the rings, in
    place. n_last (a 0-d int32 tensor) is the insert ordinal of the last
    staged block; the pair's inserts were n_last - 4 .. n_last. The first
    flush writes the zero staging rows into the zero rings, a no-op by
    value."""
    # Slot s lives at sf row s_write(n_last) + 4 - s: ascending rows hold
    # descending slots.
    _ring_write_group(geo, state.sf, torch.flip(state.sf_pending, dims=[1]),
                      s_write_index(geo, n_last))
    _ring_write_group(geo, state.blocks, state.blocks_pending,
                      b_write_index(geo, n_last - (PAIR_BLOCKS - 1)))
    return state


def buffer_latency(geo: BufferGeometry, state) -> torch.Tensor:
    """BufferLatency (render_delay_buffer.cc:431-436), in blocks."""
    return torch.div(state.lr_latency, geo.sub_block_size,
                     rounding_mode="floor")


def prepare_capture_processing(geo: BufferGeometry,
                               config: EchoCanceller3Config,
                               state: RenderDelayBufferState):
    """RenderDelayBufferImpl::PrepareCaptureProcessing
    (render_delay_buffer.cc:238-289). Returns (state, event, activity)."""
    latency = buffer_latency(geo, state)
    min_latency = torch.minimum(state.min_latency_blocks, latency)
    counter = state.excess_render_detection_counter + 1
    check = counter >= config.buffering.excess_render_detection_interval_blocks
    excess = check & (
        min_latency > config.buffering.max_allowed_excess_render_blocks)
    min_latency_blocks = torch.where(check, latency, min_latency)
    counter = torch.where(check, 0, counter)

    underrun = state.lr_latency == 0
    b_delay_inc = torch.where(state.b_delay != 0, state.b_delay - 1,
                              state.b_delay)
    normal_lr = torch.remainder(state.lr_latency - geo.sub_block_size,
                                geo.ds_size)
    under_delay = torch.where(state.has_delay,
                              torch.clamp(state.delay - 1, min=0),
                              state.delay)
    z = torch.zeros_like(state.b_delay)
    new = state.replace(
        b_delay=torch.where(excess, z + config.delay.default_delay,
                            b_delay_inc).to(torch.int32),
        lr_latency=torch.where(
            excess, z + geo.sub_block_size,
            torch.where(underrun, state.lr_latency, normal_lr)
        ).to(torch.int32),
        delay=torch.where(~excess & underrun, under_delay,
                          state.delay).to(torch.int32),
        has_delay=state.has_delay & ~excess,
        min_latency_blocks=torch.where(excess, z,
                                       min_latency_blocks).to(torch.int32),
        excess_render_detection_counter=torch.where(
            excess, z, counter).to(torch.int32),
    )
    event = torch.where(
        excess, EVENT_RENDER_OVERRUN,
        torch.where(underrun, EVENT_RENDER_UNDERRUN, EVENT_NONE)
    ).to(torch.int32)

    # Render activity hand-off (:283-287).
    activity = new.render_activity
    new = new.replace(
        render_activity_counter=torch.where(
            activity, 0, new.render_activity_counter).to(torch.int32),
        render_activity=torch.zeros_like(activity),
    )
    return new, event, activity


def align_from_delay(geo: BufferGeometry, config: EchoCanceller3Config,
                     state: RenderDelayBufferState, delay: torch.Tensor):
    """RenderDelayBufferImpl::AlignFromDelay (render_delay_buffer.cc:292-318).

    Returns (state, changed (B,) bool)."""
    unchanged = state.has_delay & (state.delay == delay)
    latency = buffer_latency(geo, state)
    total = torch.clamp(latency + delay, 0, geo.max_delay)
    return state.replace(
        b_delay=torch.where(unchanged, state.b_delay, total).to(torch.int32),
        delay=torch.where(unchanged, state.delay, delay).to(torch.int32),
        has_delay=torch.ones_like(state.has_delay),
    ), ~unchanged


# ---------------------------------------------------------------- reads


class RenderView(NamedTuple):
    """A RenderBuffer read handle (render_buffer.h): the buffer state and
    the uniform insert ordinal ``n`` of its last insert (a 0-d int32
    tensor). ``pending_count`` staged rows (ordinals n - pending_count + 1
    .. n) live in the staging buffers rather than the rings."""

    state: RenderDelayBufferState
    n: torch.Tensor
    pending_count: int = 0


def _span(buf: torch.Tensor, start: torch.Tensor, W: int) -> torch.Tensor:
    """Rows [start, start + W) of a mirrored ring per stream, through K2:
    buf (B, LP, F) float32 or bf16, start (B,) in [0, L) -> (B, W, F)
    float32."""
    return cuda_span.span_gather(buf, start, W)


def _overlay(geo: BufferGeometry, rows: torch.Tensor, start: torch.Tensor,
             W: int, first: int, step: int, pending: torch.Tensor):
    """Replace each row whose ring position is that of a staged row by the
    staged row: slot s of ``pending`` (B, k, F) sits at ring position
    (first + step * s) mod L."""
    dev = rows.device
    k = pending.shape[1]
    row_log = torch.remainder(
        start[:, None] + torch.arange(W, device=dev), geo.num_blocks)
    pos = torch.remainder(first + step * torch.arange(k, device=dev),
                          geo.num_blocks)
    match = row_log[:, :, None] == pos  # (B, W, k)
    hit = torch.any(match, dim=2)
    slot = torch.argmax(match.to(torch.int32), dim=2)  # (B, W)
    staged = torch.gather(
        pending, 1, slot[:, :, None].expand(-1, -1, pending.shape[2]))
    return torch.where(hit[:, :, None], staged, rows)


def sf_span(geo: BufferGeometry, view: RenderView, start: torch.Tensor,
            W: int) -> torch.Tensor:
    """Span read [start, start + W) of the sf ring with the write-behind
    overlay: rows at a staged insert's position read the staged row."""
    rows = _span(view.state.sf, start, W)
    k = view.pending_count
    if k:
        # Slot s holds insert n - (k - 1) + s, at s_write = -(that) mod L.
        rows = _overlay(geo, rows, start, W, (k - 1) - view.n, -1,
                        view.state.sf_pending[:, :k])
    return rows


def blocks_span(geo: BufferGeometry, view: RenderView, start: torch.Tensor,
                W: int) -> torch.Tensor:
    """Span read of the blocks ring with the write-behind overlay (blocks
    positions ascend with n: b_write(n) = n mod L)."""
    rows = _span(view.state.blocks, start, W)
    k = view.pending_count
    if k:
        rows = _overlay(geo, rows, start, W, view.n - (k - 1), 1,
                        view.state.blocks_pending[:, :k])
    return rows


def sf_fft(geo: BufferGeometry, rows: torch.Tensor) -> torch.Tensor:
    """FFT planes of packed sf rows: (B, W, fp) -> (B, W, C, 65) complex."""
    shape = rows.shape[:2] + geo.spec_row_shape
    half = geo.fft_row_f // 2
    return torch.complex(rows[..., :half].reshape(shape),
                         rows[..., half: geo.fft_row_f].reshape(shape))


def sf_spectrum(geo: BufferGeometry, rows: torch.Tensor) -> torch.Tensor:
    """Spectrum part of packed sf rows: (B, W, fp) -> (B, W, C, 65)."""
    f = geo.fft_row_f
    return rows[..., f: f + geo.spec_row_f].reshape(
        rows.shape[:2] + geo.spec_row_shape)


def blocks_rows(geo: BufferGeometry, rows: torch.Tensor) -> torch.Tensor:
    """Packed block rows (B, W, fp) -> (B, W, bands, 64, C)."""
    return rows[..., : geo.blocks_row_f].reshape(
        rows.shape[:2] + geo.block_row_shape)


def sf_window(geo: BufferGeometry, view: RenderView, width: int):
    """The packed (B, width, sf_row_fp) rows at the read position."""
    if width > geo.pad + 1:
        raise ValueError(f"window {width} wider than the mirror allows")
    return sf_span(geo, view, s_read_index(geo, view.state, view.n), width)


def fft_window(geo: BufferGeometry, view: RenderView, num_partitions: int):
    """The ``num_partitions`` FFTs from Position() on: (B, P, C, 65)."""
    return sf_fft(geo, sf_window(geo, view, num_partitions))


def spectrum_window(geo: BufferGeometry, view: RenderView,
                    num_partitions: int):
    """(B, P, C, 65) spectra from the read position on."""
    return sf_spectrum(geo, sf_window(geo, view, num_partitions))


def spectrum_at(geo: BufferGeometry, view: RenderView, offset):
    """RenderBuffer::Spectrum(offset): (B, C, 65)."""
    idx = torch.remainder(s_read_index(geo, view.state, view.n) + offset,
                          geo.num_blocks)
    return sf_spectrum(geo, sf_span(geo, view, idx, 1))[:, 0]


def block_window_back(geo: BufferGeometry, view: RenderView, W: int):
    """Blocks at b_read - [0, W): (B, W, bands, 64, C), row k the block k
    blocks before the read position."""
    if W > geo.pad + 1:
        raise ValueError(f"window {W} wider than the mirror allows")
    start = torch.remainder(b_read_index(geo, view.state, view.n) - (W - 1),
                            geo.num_blocks)
    return blocks_rows(geo, torch.flip(blocks_span(geo, view, start, W),
                                       dims=[1]))


def window_row(win: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    """Row ``offset`` of a window (B, W, ...) per stream: offset (B,) gives
    (B, ...), offset (B, k) gives (B, k, ...). Offsets lie in [0, W)."""
    return take(win, offset)


def window_slice(win: torch.Tensor, start: torch.Tensor, W: int):
    """Rows [start, start + W) of a window (B, Wc, ...) per stream."""
    idx = start[:, None] + torch.arange(W, device=win.device)
    return take(win, idx)


def block_at(geo: BufferGeometry, view: RenderView, offset: int = 0):
    """RenderBuffer::GetBlock(offset): (B, bands, 64, C)."""
    idx = torch.remainder(b_read_index(geo, view.state, view.n) + offset,
                          geo.num_blocks)
    return blocks_rows(geo, blocks_span(geo, view, idx, 1))[:, 0]


def spectral_sum(geo: BufferGeometry, view: RenderView, num_spectra: int):
    """RenderBuffer::SpectralSum (render_buffer.cc:29-41): (B, 65)."""
    return torch.sum(spectrum_window(geo, view, num_spectra), dim=(1, 2))


def headroom(geo: BufferGeometry, state) -> torch.Tensor:
    """RenderBuffer::Headroom (render_buffer.h:80-92)."""
    return torch.where(state.b_delay == 0, geo.num_blocks, state.b_delay)


def compute_delay(geo: BufferGeometry, state) -> torch.Tensor:
    """RenderDelayBufferImpl::ComputeDelay (render_delay_buffer.cc:338-346)."""
    return state.b_delay - buffer_latency(geo, state)
