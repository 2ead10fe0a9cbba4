"""Adaptive reverb decay estimation for AEC3.

Port of ``webrtc_audio_processing_tpu/models/aec3/reverb_decay_estimator.py``
(reference: aec3/reverb_decay_estimator.cc, driven by
reverb_model_estimator.cc:43-68). Active only when
``ep_strength.default_len < 0``; otherwise ``decay_value`` returns the fixed
decay. State is (B, C, ...); only channel 0's decay is used.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from webrtc_audio_processing_tpu_torch.models.aec3.fast_log2 import (
    fast_approx_log2,
)
from webrtc_audio_processing_tpu_torch.ops.batch import tree_where

BLOCK = 64
EARLY_MIN_BLOCKS = 3  # kEarlyReverbMinSizeBlocks
BLOCKS_PER_SECTION = 6
FIRST_POINT = -0.5 * BLOCKS_PER_SECTION * BLOCK + 0.5
NUM_SECTIONS_TO_ANALYZE = 9
_I32 = torch.int32


def _sym_sum(n):
    """SymmetricArithmetricSum: N(N^2-1)/12."""
    return n * (n * n - 1.0) / 12.0


@dataclass
class ReverbDecayState:
    """ReverbDecayEstimator members (.h:50-120), (B, C, ...)."""

    decay: torch.Tensor  # (B, C)
    tail_gain: torch.Tensor
    smoothing_constant: torch.Tensor
    block_to_analyze: torch.Tensor  # int32
    region_candidate_size: torch.Tensor  # int32
    region_identified: torch.Tensor  # bool
    late_reverb_start: torch.Tensor  # int32
    late_reverb_end: torch.Tensor  # int32
    previous_gains: torch.Tensor  # (B, C, L)
    lr_nz: torch.Tensor
    lr_nn: torch.Tensor
    lr_count: torch.Tensor
    lr_N: torch.Tensor  # int32
    lr_n: torch.Tensor  # int32
    er_numerators: torch.Tensor  # (B, C, S)
    er_numerators_smooth: torch.Tensor  # (B, C, S)
    er_block_counter: torch.Tensor  # int32
    er_n_sections: torch.Tensor  # int32

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def num_early_sections(config) -> int:
    """numerators_ size: (length_blocks - 3) - kBlocksPerSection (.cc:316)."""
    return max(config.filter.refined.length_blocks - EARLY_MIN_BLOCKS
               - BLOCKS_PER_SECTION, 1)


def init_state(config, num_capture: int, batch: int,
               device) -> ReverbDecayState:
    bc = (batch, num_capture)
    L = config.filter.refined.length_blocks
    s = num_early_sections(config)
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=_I32, device=device)
    return ReverbDecayState(
        decay=torch.full(bc, abs(config.ep_strength.default_len), **f32),
        tail_gain=torch.zeros(bc, **f32),
        smoothing_constant=torch.zeros(bc, **f32),
        block_to_analyze=torch.zeros(bc, **i32),
        region_candidate_size=torch.zeros(bc, **i32),
        region_identified=torch.zeros(bc, dtype=torch.bool, device=device),
        late_reverb_start=torch.full(bc, EARLY_MIN_BLOCKS, **i32),
        late_reverb_end=torch.full(bc, EARLY_MIN_BLOCKS, **i32),
        previous_gains=torch.zeros(bc + (L,), **f32),
        lr_nz=torch.zeros(bc, **f32),
        lr_nn=torch.zeros(bc, **f32),
        lr_count=torch.zeros(bc, **f32),
        lr_N=torch.zeros(bc, **i32),
        lr_n=torch.zeros(bc, **i32),
        er_numerators=torch.zeros(bc + (s,), **f32),
        er_numerators_smooth=torch.zeros(bc + (s,), **f32),
        er_block_counter=torch.zeros(bc, **i32),
        er_n_sections=torch.zeros(bc, **i32),
    )


def _reset_estimation(st: ReverbDecayState) -> ReverbDecayState:
    """ResetDecayEstimation (.cc:151-161): all but decay_ and tail_gain_."""
    z_i = torch.zeros_like(st.block_to_analyze)
    z_f = torch.zeros_like(st.lr_nz)
    return st.replace(
        smoothing_constant=z_f, block_to_analyze=z_i,
        region_candidate_size=z_i,
        region_identified=torch.zeros_like(st.region_identified),
        late_reverb_start=z_i, late_reverb_end=z_i,
        lr_nz=z_f, lr_nn=z_f, lr_count=z_f, lr_N=z_i, lr_n=z_i,
        er_numerators=torch.zeros_like(st.er_numerators),
        er_block_counter=z_i, er_n_sections=z_i,
    )


def _block_of(h, block_idx):
    """The 64 coefficients of block ``block_idx`` (B, C) of h (B, C, T)."""
    offs = block_idx[..., None].to(torch.int64) * BLOCK + torch.arange(
        BLOCK, device=h.device)
    return torch.gather(h, 2, offs)


def _early_estimate(st: ReverbDecayState):
    """EarlyReverbLengthEstimator::Estimate (.cc:364-400)."""
    n_sec = st.er_n_sections
    S = st.er_numerators_smooth.shape[2]
    nn = _sym_sum(float(BLOCKS_PER_SECTION * BLOCK))
    numerator_11 = 0.13750352374993502 * nn / BLOCK
    numerator_08 = -0.32192809488736229 * nn / BLOCK
    idx = torch.arange(S, device=n_sec.device)
    sm = st.er_numerators_smooth
    tail_mask = (idx >= NUM_SECTIONS_TO_ANALYZE) & (idx < n_sec[..., None])
    min_tail = torch.amin(torch.where(tail_mask, sm, float("inf")), dim=2)
    head = idx < min(NUM_SECTIONS_TO_ANALYZE, S)
    hit = head & ((sm > numerator_11) | (
        (sm < numerator_08) & (sm < 0.9 * min_tail[..., None])))
    k = torch.amax(torch.where(hit, idx, 0), dim=2)
    size_m1 = torch.where(torch.any(hit, dim=2), k, 0)
    est = torch.where(size_m1 == 0, 0, size_m1 + 1)
    return torch.where(n_sec < NUM_SECTIONS_TO_ANALYZE, 0, est).to(_I32)


def _analyze_filter(st: ReverbDecayState, h):
    """AnalyzeFilter (.cc:228-272) for each channel's current block."""
    L = st.previous_gains.shape[2]
    dev = h.device
    bta = torch.clamp(st.block_to_analyze, 0, L - 1)
    h2 = _block_of(h, bta) ** 2  # (B, C, 64)

    gain = torch.clamp(torch.mean(h2, dim=2), min=1e-32)
    prev = torch.gather(st.previous_gains, 2, bta[..., None].long())[..., 0]
    adapting = (prev > 1.1 * gain) | (prev < 0.9 * gain)
    decaying = gain > st.tail_gain
    prev_gains = torch.where(
        torch.arange(L, device=dev) == bta[..., None], gain[..., None],
        st.previous_gains)
    identified = st.region_identified | adapting | ~decaying
    cand = st.region_candidate_size + torch.where(identified, 0, 1)

    in_late_window = st.block_to_analyze <= st.late_reverb_end
    in_late = in_late_window & (st.block_to_analyze >= st.late_reverb_start)
    v = fast_approx_log2(h2 + 1e-10)  # (B, C, 64)
    sum_v = torch.sum(v, dim=2)

    j = torch.arange(BLOCK, dtype=torch.float32, device=dev)
    nz_inc = torch.sum((st.lr_count[..., None] + j) * v, dim=2)
    lr_nz = torch.where(in_late, st.lr_nz + nz_inc, st.lr_nz)
    lr_count = torch.where(in_late, st.lr_count + BLOCK, st.lr_count)
    lr_n = torch.where(in_late, st.lr_n + BLOCK, st.lr_n)

    S = st.er_numerators.shape[2]
    bc = st.er_block_counter
    sec = torch.arange(S, device=dev)
    sec_mask = (
        (sec >= torch.clamp(bc - BLOCKS_PER_SECTION + 1, min=0)[..., None])
        & (sec <= torch.clamp(bc, max=S - 1)[..., None]))
    A = torch.sum(v * (j + FIRST_POINT), dim=2)
    inc = A[..., None] + (bc[..., None] - sec).to(torch.float32) * (
        BLOCK * sum_v[..., None])
    numer = torch.where(in_late_window[..., None] & sec_mask,
                        st.er_numerators + inc, st.er_numerators)
    close_sec = bc - (BLOCKS_PER_SECTION - 1)
    do_close = in_late_window & (close_sec >= 0) & (close_sec < S)
    cs = torch.clamp(close_sec, 0, S - 1)
    cur_n = torch.gather(numer, 2, cs[..., None].long())[..., 0]
    cur_s = torch.gather(st.er_numerators_smooth, 2,
                         cs[..., None].long())[..., 0]
    new_s = cur_s + st.smoothing_constant * (cur_n - cur_s)
    smooth = torch.where(do_close[..., None] & (sec == cs[..., None]),
                         new_s[..., None], st.er_numerators_smooth)
    return st.replace(
        previous_gains=prev_gains,
        region_identified=identified,
        region_candidate_size=cand.to(_I32),
        lr_nz=lr_nz, lr_count=lr_count, lr_n=lr_n.to(_I32),
        er_numerators=numer,
        er_numerators_smooth=smooth,
        er_block_counter=torch.where(in_late_window, bc + 1, bc).to(_I32),
        er_n_sections=torch.where(do_close, cs + 1,
                                  st.er_n_sections).to(_I32),
        block_to_analyze=(st.block_to_analyze + 1).to(_I32),
    )


def _estimate_decay(st: ReverbDecayState, h, peak_block):
    """EstimateDecay (.cc:163-226) for channels whose analysis completed."""
    L = st.previous_gains.shape[2]
    new_bta = torch.clamp(peak_block + EARLY_MIN_BLOCKS, max=L)
    first_gain = torch.mean(_block_of(h, torch.clamp(new_bta, 0, L - 1)) ** 2,
                            dim=2)
    tail_gain = torch.mean(
        _block_of(h, torch.full_like(new_bta, L - 1)) ** 2, dim=2)
    peak_energy = torch.amax(
        _block_of(h, torch.clamp(peak_block, 0, L - 1)) ** 2, dim=2)
    sufficient = first_gain > 4.0 * tail_gain
    valid_filter = (first_gain > 2.0 * tail_gain) & (peak_energy < 100.0)

    size_early = _early_estimate(st)
    size_late = torch.clamp(st.region_candidate_size - size_early, min=0)
    available = (st.lr_n == st.lr_N) & (st.lr_N != 0)
    slope = st.lr_nz / torch.clamp(st.lr_nn, min=1e-30)
    new_decay = torch.exp2(slope * BLOCK)
    new_decay = torch.maximum(0.97 * st.decay, new_decay)
    new_decay = torch.clamp(new_decay, 0.02, 0.95)  # kMinDecay / kMaxDecay
    do_decay = (size_late >= 5) & valid_filter & available
    decay = torch.where(
        do_decay, st.decay + st.smoothing_constant * (new_decay - st.decay),
        st.decay)

    enough_late = size_late >= 5
    N = torch.where(enough_late, size_late * BLOCK, 0)
    Nf = N.to(torch.float32)
    return st.replace(
        decay=decay,
        tail_gain=tail_gain,
        block_to_analyze=new_bta.to(_I32),
        region_identified=~(valid_filter & sufficient),
        region_candidate_size=torch.zeros_like(st.region_candidate_size),
        smoothing_constant=torch.zeros_like(st.smoothing_constant),
        late_reverb_start=torch.where(
            enough_late, peak_block + EARLY_MIN_BLOCKS + size_early,
            0).to(_I32),
        late_reverb_end=torch.where(
            enough_late, new_bta + st.region_candidate_size - 1, 0).to(_I32),
        lr_nz=torch.zeros_like(st.lr_nz),
        lr_nn=torch.where(enough_late, _sym_sum(Nf), 0.0),
        lr_count=torch.where(N > 0, -Nf * 0.5 + 0.5, 0.0),
        lr_N=N.to(_I32),
        lr_n=torch.zeros_like(st.lr_n),
        er_numerators=torch.zeros_like(st.er_numerators),
        er_block_counter=torch.zeros_like(st.er_block_counter),
    )


def update(config, st: ReverbDecayState, h_adjusted, quality, quality_valid,
           filter_delay_blocks, usable, stationary, filter_size_blocks):
    """ReverbDecayEstimator::Update (.cc:107-149), all channels at once.
    h_adjusted (B, C, L * 64); quality, quality_valid and
    filter_delay_blocks (B, C); usable, stationary, filter_size_blocks (B,).
    """
    L = config.filter.refined.length_blocks
    feasible = ((filter_delay_blocks <= L - EARLY_MIN_BLOCKS - 1)
                & (filter_size_blocks == L)[:, None]
                & (filter_delay_blocks > 0) & usable[:, None])
    run = ~stationary[:, None]
    st = tree_where(run & ~feasible, _reset_estimation(st), st)
    active = run & feasible
    smoothing = torch.maximum(torch.where(quality_valid, quality * 0.2, 0.0),
                              st.smoothing_constant)
    st = st.replace(smoothing_constant=torch.where(active, smoothing,
                                                   st.smoothing_constant))
    live = active & (smoothing != 0.0)
    analyzing = st.block_to_analyze < L
    st_new = tree_where(analyzing, _analyze_filter(st, h_adjusted),
                        _estimate_decay(st, h_adjusted, filter_delay_blocks))
    return tree_where(live, st_new, st)


def decay_value(config, st: ReverbDecayState | None, mild):
    """ReverbDecayEstimator::Decay (.h:37-43): (B,); the adaptive decay
    ignores ``mild`` (B,) bool."""
    if config.ep_strength.default_len < 0 and st is not None:
        return st.decay[:, 0]
    return torch.where(mild, abs(config.ep_strength.nearend_len),
                       abs(config.ep_strength.default_len)).to(torch.float32)
