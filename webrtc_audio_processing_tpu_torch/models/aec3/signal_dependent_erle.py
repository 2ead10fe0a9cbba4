"""Signal-dependent ERLE estimator for AEC3.

Port of ``webrtc_audio_processing_tpu/models/aec3/signal_dependent_erle.py``
(reference: aec3/signal_dependent_erle_estimator.cc). Created only when
``erle.num_sections > 1`` (erle_estimator.cc:37-41): it corrects the subband
ERLE per (active-section count, subband). State is (B, C, ...).
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass

import torch

NUM_BINS = 65
SUBBANDS = 6
BAND_BOUNDARIES = (1, 8, 16, 24, 32, 48, 65)  # kBandBoundaries (:35-36)
X2_BAND_ENERGY_THRESHOLD = 44015068.0
SMOOTH_DECREASE = 0.1
SMOOTH_INCREASE = SMOOTH_DECREASE / 2.0
NUM_UPDATE_THR = 50


def form_subband_map():
    """FormSubbandMap (:38-49): bin -> subband index."""
    out = []
    sb = 1
    for k in range(NUM_BINS):
        if k >= BAND_BOUNDARIES[sb]:
            sb += 1
        out.append(sb - 1)
    return tuple(out)


def define_section_sizes(delay_headroom_blocks: int, num_blocks: int,
                         num_sections: int):
    """DefineFilterSectionSizes (:56-82): doubling sections, even split."""
    remaining_blocks = num_blocks - delay_headroom_blocks
    sizes = [0] * num_sections
    remaining_sections = num_sections
    est = 2
    idx = 0
    while remaining_sections > 1 and remaining_blocks > est * remaining_sections:
        sizes[idx] = est
        remaining_blocks -= est
        remaining_sections -= 1
        est *= 2
        idx += 1
    last = remaining_blocks // remaining_sections
    for j in range(idx, num_sections):
        sizes[j] = last
    sizes[num_sections - 1] += remaining_blocks - last * remaining_sections
    return sizes


def section_boundaries(delay_headroom_blocks: int, num_blocks: int,
                       num_sections: int):
    """SetSectionsBoundaries (:88-118): per-section block limits."""
    bounds = [0] * (num_sections + 1)
    if num_sections == 1:
        return [0, num_blocks]
    sizes = define_section_sizes(delay_headroom_blocks, num_blocks,
                                 num_sections)
    idx = 0
    cur = 0
    bounds[0] = delay_headroom_blocks
    for k in range(delay_headroom_blocks, num_blocks):
        cur += 1
        if cur >= sizes[idx]:
            idx += 1
            if idx == len(sizes):
                break
            bounds[idx] = k + 1
            cur = 0
    bounds[len(sizes)] = num_blocks
    return bounds


def max_erle_subbands(max_l: float, max_h: float):
    """SetMaxErleSubbands (:122-128): max_l below bin 32's subband."""
    limit = form_subband_map()[32]
    return [max_l] * limit + [max_h] * (SUBBANDS - limit)


@functools.lru_cache(maxsize=None)
def _tables(max_l: float, max_h: float, device: torch.device):
    """(max ERLE per subband (6,), bin -> subband map (65,), max ERLE per
    bin (65,)) on the device."""
    sub = torch.tensor(max_erle_subbands(max_l, max_h), dtype=torch.float32)
    submap = torch.tensor(form_subband_map())
    return sub.to(device), submap.to(device), sub[submap].to(device)


@dataclass
class SignalDependentErleState:
    """Adaptive members of SignalDependentErleEstimator (.h:95-105)."""

    erle: torch.Tensor  # (B, C, 65)
    erle_onset_compensated: torch.Tensor  # (B, C, 65)
    erle_estimators: torch.Tensor  # (B, C, S, 6)
    erle_ref: torch.Tensor  # (B, C, 6)
    correction_factors: torch.Tensor  # (B, C, S, 6)
    num_updates: torch.Tensor  # (B, C, 6) int32
    n_active_sections: torch.Tensor  # (B, C, 65) int32

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def init_state(config, num_capture: int, batch: int,
               device) -> SignalDependentErleState:
    mn = config.erle.min
    bc = (batch, num_capture)
    s = config.erle.num_sections
    f32 = dict(dtype=torch.float32, device=device)
    return SignalDependentErleState(
        erle=torch.full(bc + (NUM_BINS,), mn, **f32),
        erle_onset_compensated=torch.full(bc + (NUM_BINS,), mn, **f32),
        erle_estimators=torch.full(bc + (s, SUBBANDS), mn, **f32),
        erle_ref=torch.full(bc + (SUBBANDS,), mn, **f32),
        correction_factors=torch.ones(bc + (s, SUBBANDS), **f32),
        num_updates=torch.zeros(bc + (SUBBANDS,), dtype=torch.int32,
                                device=device),
        n_active_sections=torch.zeros(bc + (NUM_BINS,), dtype=torch.int32,
                                      device=device),
    )


def _subband_sums(x):
    """Sum of a (..., 65) spectrum over the 6 subband bin ranges."""
    return torch.stack(
        [torch.sum(x[..., BAND_BOUNDARIES[s]:BAND_BOUNDARIES[s + 1]], dim=-1)
         for s in range(SUBBANDS)], dim=-1)


def _active_sections(config, st, X2_by_delay, frequency_responses):
    """ComputeNumberOfActiveFilterSections (:243-254). X2_by_delay
    (B, num_blocks, 65); frequency_responses (B, C, P, 65)."""
    num_blocks = config.filter.refined.length_blocks
    headroom = config.delay.delay_headroom_samples // 64
    bounds = section_boundaries(headroom, num_blocks,
                                config.erle.num_sections)
    p_max = frequency_responses.shape[2]
    x2_secs, h2_secs = [], []
    for s in range(config.erle.num_sections):
        lo, hi = bounds[s], min(bounds[s + 1], p_max)
        x2_secs.append(torch.sum(X2_by_delay[:, lo:hi], dim=1))
        h2_secs.append(torch.sum(frequency_responses[:, :, lo:hi], dim=2))
    X2_sec = torch.stack(x2_secs, dim=1)  # (B, S, 65)
    H2_sec = torch.stack(h2_secs, dim=2)  # (B, C, S, 65)
    S2 = torch.cumsum(X2_sec[:, None] * H2_sec, dim=2)
    target = 0.9 * S2[:, :, -1:, :]
    n_active = torch.argmax((S2 >= target).to(torch.int32), dim=2)
    return st.replace(n_active_sections=n_active.to(torch.int32))


def _correction_factors(config, st, X2, Y2, E2, converged):
    """UpdateCorrectionFactors (:256-343). X2 (B, 65); Y2, E2 (B, C, 65);
    converged (B, C)."""
    mn = config.erle.min
    max_sub, _, _ = _tables(config.erle.max_l, config.erle.max_h, X2.device)
    num_sections = config.erle.num_sections
    X2_sub = _subband_sums(X2)  # (B, 6)
    Y2_sub = _subband_sums(Y2)  # (B, C, 6)
    E2_sub = _subband_sums(E2)
    idx_sub = torch.stack(
        [torch.amin(st.n_active_sections[
            ..., BAND_BOUNDARIES[s]:BAND_BOUNDARIES[s + 1]], dim=-1)
         for s in range(SUBBANDS)], dim=-1)  # (B, C, 6)

    upd = (converged[..., None] & (X2_sub[:, None] > X2_BAND_ENERGY_THRESHOLD)
           & (E2_sub > 0.0))
    new_erle = torch.where(upd, Y2_sub / torch.clamp(E2_sub, min=1e-30), 0.0)
    num_updates = st.num_updates + upd.to(torch.int32)
    onehot = (torch.arange(num_sections, device=X2.device)[:, None]
              == idx_sub[:, :, None, :])  # (B, C, S, 6)
    sel = converged[:, :, None, None] & onehot

    cur = torch.sum(torch.where(onehot, st.erle_estimators, 0.0), dim=2)
    alpha = torch.where(new_erle > cur, SMOOTH_INCREASE, SMOOTH_DECREASE)
    alpha = torch.where(upd, alpha, 0.0)
    newv = torch.minimum(torch.clamp(cur + alpha * (new_erle - cur), min=mn),
                         max_sub)
    erle_est = torch.where(sel, newv[:, :, None, :], st.erle_estimators)

    alpha_r = torch.where(new_erle > st.erle_ref, SMOOTH_INCREASE,
                          SMOOTH_DECREASE)
    alpha_r = torch.where(upd, alpha_r, 0.0)
    ref = torch.minimum(
        torch.clamp(st.erle_ref + alpha_r * (new_erle - st.erle_ref), min=mn),
        max_sub)
    ref = torch.where(converged[..., None], ref, st.erle_ref)

    cf_upd = upd & (num_updates > NUM_UPDATE_THR)
    new_cf = (torch.sum(torch.where(onehot, erle_est, 0.0), dim=2)
              / torch.clamp(ref, min=1e-30))
    cf_cur = torch.sum(torch.where(onehot, st.correction_factors, 0.0), dim=2)
    cf_new = cf_cur + 0.1 * (new_cf - cf_cur)
    cf = torch.where(sel & cf_upd[:, :, None, :], cf_new[:, :, None, :],
                     st.correction_factors)
    return st.replace(
        erle_estimators=erle_est, erle_ref=ref, correction_factors=cf,
        num_updates=torch.where(converged[..., None], num_updates,
                                st.num_updates).to(torch.int32),
    )


def update(config, st: SignalDependentErleState, X2_by_delay,
           frequency_responses, X2, Y2, E2, average_erle,
           average_erle_onset_compensated, converged):
    """SignalDependentErleEstimator::Update (:190-233)."""
    mn = config.erle.min
    _, submap, max_bins = _tables(config.erle.max_l, config.erle.max_h,
                                  X2.device)
    st = _active_sections(config, st, X2_by_delay, frequency_responses)
    st = _correction_factors(config, st, X2, Y2, E2, converged)
    B, C = st.erle.shape[:2]
    # correction_factors[b, c, n_active[b, c, k], submap[k]].
    cf = st.correction_factors[:, :, :, submap]  # (B, C, S, 65)
    cf_sel = torch.gather(cf, 2, st.n_active_sections[:, :, None, :].long()
                          )[:, :, 0]
    live = torch.arange(NUM_BINS, device=X2.device) < NUM_BINS - 1

    def bound(v):
        return torch.minimum(torch.clamp(v, min=mn), max_bins)

    erle = torch.where(live, bound(average_erle * cf_sel), st.erle)
    erle_oc = st.erle_onset_compensated
    if config.erle.onset_detection:
        erle_oc = torch.where(
            live, bound(average_erle_onset_compensated * cf_sel), erle_oc)
    return st.replace(erle=erle, erle_onset_compensated=erle_oc)
