"""K6: the AEC3 subtractor pair kernel, a hand-written CUDA kernel.

Replaces ``webrtc_audio_processing_tpu/ops/pallas_subtractor.py``
``make_pair_kernel`` (:154), whose inner ``kernel`` (:216) is launched at
:830: the subtractor loop of one frame's 2 or 3 capture blocks for every
stream and capture channel, both adaptive filters kept on chip. Its oracle is
the port's ``models/aec3/subtractor.process_pair``, which the plain twin
calls on the windows it cuts out of the render chain. See
``csrc/subtractor.cu`` for the steps.

What bounds it on an H100. Its least time is set by bytes: per launch it
reads and writes each state plane once (at 48 kHz stereo, B = 2048: refined
H 55.4 MB, coarse H 46.9 MB, frequency and impulse responses 13.8 and 13.6
MB, H_error 1.1 MB, 131 MB each way), reads the frame's window rows of the
sf chain (48 MB when the three windows overlap) and writes the per-block
outputs (89 MB at 3 blocks): 0.12 ms at 3.35 TB/s. What it takes is set by
latency: each (stream, capture channel) runs a chain of dependent steps per
block (products, two 128-point inverse and forward transforms per filter,
gains, adapt and constrain, responses), so the time is the chain's length
times the waves of blocks the card runs. The kernel keeps the chain short
and wide (``csrc/subtractor.cu``): one block per (stream, capture channel)
with its filters, window, responses and scalars in shared memory for the
frame; the transforms as FFTs on one warp each, the two filters' and the
render channels' side by side; the per-stream scalars in shared memory, so
that three 256-thread blocks fit an SM; the frame's window rows staged once
when the blocks' starts are consecutive; six barriers a block. The large
planes are read and written where the state keeps them (complex64 as
interleaved float pairs); only the per-stream scalars are packed, into a
(B, 21 + 3 C) float32 and a (B, 16 + 4 C) int32 vector in the slot order of
``pallas_subtractor.py:62-105``. Transforms and sums run in another order
than the twin's ``torch.fft``: float leaves agree to rounding, integer
leaves exactly.

Dispatch: a CUDA tensor launches the kernel (or raises); only a CPU tensor
runs the plain twin.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from webrtc_audio_processing_tpu_torch.models.aec3 import render_buffer as rb
from webrtc_audio_processing_tpu_torch.models.aec3 import subtractor as subt
from webrtc_audio_processing_tpu_torch.models.aec3.config import (
    EchoCanceller3Config,
)
from webrtc_audio_processing_tpu_torch.ops import cuda_build

# Kernel launches since the last reset; only the CUDA branch counts.
launches = 0

NUM_BINS = 65
BLOCK = 64

# Scalar slots of the packed state (pallas_subtractor.py:62-105): shared
# float slots, then per capture channel c the slot base + c.
F_RG_CUR, F_RG_TGT, F_RG_OLD = 0, 5, 10  # refined gain config (5 each)
F_CG_CUR, F_CG_TGT, F_CG_OLD = 15, 17, 19  # coarse gain config (2 each)
NF_SHARED = 21  # then mis_e2_acum, mis_y2_acum, mis_inv (C each)
I_R_CUR = 0  # refined: current, target, old target, counter, partition
I_C_CUR = 5  # coarse: the same five
I_RG_CTR, I_CG_CTR = 10, 11
I_RG_POOR, I_RG_CALL, I_CG_POOR, I_CG_CALL = 12, 13, 14, 15
NI_SHARED = 16  # then mis_blocks_acum, mis_overhang, poor coarse, hangover

# The per-block scalar outputs, in the kernel's order.
SCALAR_KEYS = ("y2", "e2_refined", "e2_coarse", "s2_refined", "s2_coarse",
               "s_refined_max_abs", "s_coarse_max_abs")


class PairState(NamedTuple):
    """The subtractor state as the kernel reads it."""

    H: torch.Tensor  # (B, C, P, R, 65) complex64, the refined filter
    H_coarse: torch.Tensor  # (B, C, Pc, R, 65) complex64
    H_error: torch.Tensor  # (B, C, 65)
    freq: torch.Tensor  # (B, C, P, 65) refined frequency responses
    imp: torch.Tensor  # (B, C, P * 64) refined impulse responses
    fs: torch.Tensor  # (B, 21 + 3 C) float32 scalar slots
    iv: torch.Tensor  # (B, 16 + 4 C) int32 scalar slots


class PairOutputs(NamedTuple):
    """Per-block outputs, block k at index k of axis 1."""

    e_refined: torch.Tensor  # (B, nb, C, 64)
    e_coarse: torch.Tensor  # (B, nb, C, 64)
    scalars: torch.Tensor  # (B, nb, C, 7) in SCALAR_KEYS order
    freq: torch.Tensor  # (B, nb, C, P, 65)
    imp: torch.Tensor  # (B, nb, C, P * 64)
    size: torch.Tensor  # (B, nb) int32, the refined filter's current size


def pack(state: subt.SubtractorState) -> PairState:
    """The kernel's view of a SubtractorState: the planes as they are, the
    scalars packed (three small concatenations)."""
    r, c = state.refined, state.coarse
    rg, cg = state.refined_gain, state.coarse_gain
    fs = torch.cat([rg.config.current, rg.config.target, rg.config.old_target,
                    cg.config.current, cg.config.target, cg.config.old_target,
                    state.mis_e2_acum, state.mis_y2_acum, state.mis_inv],
                   dim=1)
    shared = torch.stack([
        r.current_size, r.target_size, r.old_target_size,
        r.size_change_counter, r.partition_to_constrain,
        c.current_size, c.target_size, c.old_target_size,
        c.size_change_counter, c.partition_to_constrain,
        rg.config.counter, cg.config.counter,
        rg.poor_excitation_counter, rg.call_counter,
        cg.poor_excitation_counter, cg.call_counter], dim=1)
    iv = torch.cat([shared, state.mis_blocks_acum, state.mis_overhang,
                    state.poor_coarse_filter_counters,
                    state.coarse_filter_reset_hangover], dim=1)
    return PairState(r.H, c.H, rg.H_error, state.refined_frequency_responses,
                     state.refined_impulse_responses, fs, iv)


def unpack(a: PairState) -> subt.SubtractorState:
    """The SubtractorState of packed arrays; its scalars are views of the
    slot vectors."""
    C = a.H.shape[1]
    fs, iv = a.fs, a.iv

    def config(cur, tgt, old, K, ctr):
        return subt.GainConfigState(current=fs[:, cur:cur + K],
                                    target=fs[:, tgt:tgt + K],
                                    old_target=fs[:, old:old + K],
                                    counter=iv[:, ctr])

    def filt(H, base):
        return subt.FilterState(
            H=H, current_size=iv[:, base], target_size=iv[:, base + 1],
            old_target_size=iv[:, base + 2],
            size_change_counter=iv[:, base + 3],
            partition_to_constrain=iv[:, base + 4])

    def per_channel(v, base, j):
        return v[:, base + j * C:base + (j + 1) * C]

    return subt.SubtractorState(
        refined=filt(a.H, I_R_CUR),
        coarse=filt(a.H_coarse, I_C_CUR),
        refined_gain=subt.RefinedGainState(
            config=config(F_RG_CUR, F_RG_TGT, F_RG_OLD, 5, I_RG_CTR),
            H_error=a.H_error, poor_excitation_counter=iv[:, I_RG_POOR],
            call_counter=iv[:, I_RG_CALL]),
        coarse_gain=subt.CoarseGainState(
            config=config(F_CG_CUR, F_CG_TGT, F_CG_OLD, 2, I_CG_CTR),
            poor_excitation_counter=iv[:, I_CG_POOR],
            call_counter=iv[:, I_CG_CALL]),
        mis_e2_acum=per_channel(fs, NF_SHARED, 0),
        mis_y2_acum=per_channel(fs, NF_SHARED, 1),
        mis_inv=per_channel(fs, NF_SHARED, 2),
        mis_blocks_acum=per_channel(iv, NI_SHARED, 0),
        mis_overhang=per_channel(iv, NI_SHARED, 1),
        poor_coarse_filter_counters=per_channel(iv, NI_SHARED, 2),
        coarse_filter_reset_hangover=per_channel(iv, NI_SHARED, 3),
        refined_frequency_responses=a.freq,
        refined_impulse_responses=a.imp,
    )


def pair_plain(config: EchoCanceller3Config, geo: rb.BufferGeometry,
               st: PairState, sf_chain, offsets, ys, narrow_masks, events,
               saturated_capture):
    """Plain PyTorch twin: block k's window is rows [offsets[:, k],
    offsets[:, k] + P) of the packed sf chain, and ``subtractor.
    process_pair`` runs on the unpacked state. See ``pair`` for shapes."""
    P = st.H.shape[2]
    rows = [rb.window_slice(sf_chain, off, P) for off in offsets.unbind(1)]
    new, outs = subt.process_pair(
        config, unpack(st), [rb.sf_fft(geo, w) for w in rows],
        [rb.sf_spectrum(geo, w) for w in rows], list(ys.unbind(1)),
        list(narrow_masks.unbind(1)), list(events[..., 0].unbind(1)),
        list(events[..., 1].unbind(1)), list(events[..., 2].unbind(1)),
        saturated_capture)

    def stack(key):
        return torch.stack([o[key] for o in outs], dim=1)

    return pack(new), PairOutputs(
        e_refined=stack("e_refined"), e_coarse=stack("e_coarse"),
        scalars=torch.stack([stack(k) for k in SCALAR_KEYS], dim=-1),
        freq=stack("refined_frequency_responses"),
        imp=stack("refined_impulse_responses"),
        size=stack("refined_current_size"))


def _check(st: PairState, sf_chain, offsets, ys, narrow_masks, events,
           saturated_capture):
    B, C, P, R, K = st.H.shape
    Pc = st.H_coarse.shape[2]
    nb = ys.shape[1]
    want = {
        "H": (st.H, (B, C, P, R, K), torch.complex64),
        "H_coarse": (st.H_coarse, (B, C, Pc, R, K), torch.complex64),
        "H_error": (st.H_error, (B, C, K), torch.float32),
        "freq": (st.freq, (B, C, P, K), torch.float32),
        "imp": (st.imp, (B, C, P * BLOCK), torch.float32),
        "fs": (st.fs, (B, NF_SHARED + 3 * C), torch.float32),
        "iv": (st.iv, (B, NI_SHARED + 4 * C), torch.int32),
        "ys": (ys, (B, nb, C, BLOCK), torch.float32),
        "narrow_masks": (narrow_masks, (B, nb, K), torch.bool),
        "events": (events, (B, nb, 3), torch.bool),
        "saturated_capture": (saturated_capture, (B,), torch.bool),
    }
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: need {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if (K != NUM_BINS or Pc > P or sf_chain.dim() != 3
            or sf_chain.shape[0] != B or sf_chain.shape[1] < P
            or sf_chain.shape[2] < 3 * R * NUM_BINS
            or sf_chain.dtype != torch.float32):
        raise ValueError(
            f"need 65 bins, Pc <= P and a float32 sf chain (B, >= P, >= "
            f"{3 * R * NUM_BINS}); got H {tuple(st.H.shape)}, coarse "
            f"{tuple(st.H_coarse.shape)}, chain {tuple(sf_chain.shape)} "
            f"{sf_chain.dtype}")
    if (tuple(offsets.shape) != (B, nb) or offsets.dtype.is_floating_point
            or nb < 1):
        raise ValueError(f"offsets: need integer (B, nb) = {(B, nb)}, got "
                         f"{tuple(offsets.shape)} {offsets.dtype}")
    for t in (*st, sf_chain, offsets, ys, narrow_masks, events,
              saturated_capture):
        if t.device != st.H.device:
            raise ValueError(f"inputs on {t.device} and {st.H.device}")


def _config_args(config: EchoCanceller3Config, P: int, Pc: int):
    """The kernel's host-side constants: 14 gain-config floats and 6 ints."""
    f = config.filter
    floats = (*subt._refined_cfg_vec(f.refined),
              *subt._coarse_cfg_vec(f.coarse),
              *subt._refined_cfg_vec(f.refined_initial),
              *subt._coarse_cfg_vec(f.coarse_initial))
    ints = (f.config_change_duration_blocks,
            min(P, f.refined_initial.length_blocks),
            min(Pc, f.coarse_initial.length_blocks),
            min(P, f.refined.length_blocks), min(Pc, f.coarse.length_blocks),
            f.coarse_reset_hangover_blocks)
    return (ctypes.c_float * 14)(*floats), (ctypes.c_int * 6)(*ints)


def launch_args(config: EchoCanceller3Config, st: PairState, sf_chain,
                offsets, ys, narrow_masks, events, saturated_capture):
    """The arguments of ``subtractor_pair_f32`` but the stream, the (new
    PairState, PairOutputs) the launch writes, and the input tensors the
    pointers point into (the caller holds them until the launch is
    enqueued: a contiguous copy would otherwise be freed first)."""
    _check(st, sf_chain, offsets, ys, narrow_masks, events,
           saturated_capture)
    B, C, P, R, _ = st.H.shape
    Pc = st.H_coarse.shape[2]
    nb = ys.shape[1]
    dev = st.H.device
    st = PairState(*(t.contiguous() for t in st))
    inputs = (*st, sf_chain.contiguous(),
              offsets.to(torch.int32).contiguous(), ys.contiguous(),
              narrow_masks.contiguous(), events.contiguous(),
              saturated_capture.contiguous())
    new = PairState(*(torch.empty_like(t) for t in st))
    f32 = dict(dtype=torch.float32, device=dev)
    out = PairOutputs(
        e_refined=torch.empty((B, nb, C, BLOCK), **f32),
        e_coarse=torch.empty((B, nb, C, BLOCK), **f32),
        scalars=torch.empty((B, nb, C, len(SCALAR_KEYS)), **f32),
        freq=torch.empty((B, nb, C, P, NUM_BINS), **f32),
        imp=torch.empty((B, nb, C, P * BLOCK), **f32),
        size=torch.empty((B, nb), dtype=torch.int32, device=dev))
    fcfg, icfg = _config_args(config, P, Pc)
    args = (*(t.data_ptr() for t in (*inputs, *new, *out)), B, C, P, Pc, R,
            sf_chain.shape[1], sf_chain.shape[2], nb, fcfg, icfg)
    return args, (new, out), inputs


def pair_cuda(config: EchoCanceller3Config, st: PairState, sf_chain, offsets,
              ys, narrow_masks, events, saturated_capture):
    """Launch the kernel on PyTorch's current stream; it reads the chain
    rows as [re | im | spectrum | 0]."""
    global launches
    args, result, _inputs = launch_args(config, st, sf_chain, offsets, ys,
                                        narrow_masks, events,
                                        saturated_capture)
    rc = cuda_build.library().lib.subtractor_pair_f32(
        *args, cuda_build.raw_stream(st.H))
    cuda_build.check(rc, "subtractor_pair_f32")
    launches += 1
    return result


def pair(config: EchoCanceller3Config, geo: rb.BufferGeometry,
         st: PairState, sf_chain, offsets, ys, narrow_masks, events,
         saturated_capture):
    """The subtractor over one frame's nb blocks.

    st: the packed state (``pack``); sf_chain (B, W2, F) the packed sf rows
    of the frame's two chains; offsets (B, nb) each block's window start in
    the chain; ys (B, nb, C, 64) the capture blocks; narrow_masks (B, nb,
    65) bool; events (B, nb, 3) bool: poor render excitation, delay change
    and initial-state transition before the block; saturated_capture (B,)
    bool. Returns (the new PairState, PairOutputs)."""
    args = (st, sf_chain, offsets, ys, narrow_masks, events,
            saturated_capture)
    if st.H.device.type == "cuda":
        return pair_cuda(config, *args)
    if st.H.device.type == "cpu":
        _check(*args)
        return pair_plain(config, geo, *args)
    raise ValueError(f"unsupported device {st.H.device}")
