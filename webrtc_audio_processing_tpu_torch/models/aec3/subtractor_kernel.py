"""The AEC3 subtractor on the pair kernel (K6): the echo remover's bridge.

Port of ``webrtc_audio_processing_tpu/models/aec3/subtractor_kernel.py``.
``process_pair_kernel`` takes what ``echo_remover.process_capture_pair``
has at hand (the frame's packed sf chain and each block's offset into it, in
place of the per-block FFT windows), runs ``ops/cuda_subtractor.pair`` and
returns what ``subtractor.process_pair`` returns: the new state and one
outputs dict per block with the keys the echo remover's phase C reads. The
JAX twin's ``custom_vmap``, stream tiling and padding exist for Mosaic and
are not ported: here every tensor is batch-first.
"""

from __future__ import annotations

import torch

from webrtc_audio_processing_tpu_torch.models.aec3 import render_buffer as rb
from webrtc_audio_processing_tpu_torch.models.aec3 import subtractor as subt
from webrtc_audio_processing_tpu_torch.models.aec3.config import (
    EchoCanceller3Config,
)
from webrtc_audio_processing_tpu_torch.ops import cuda_subtractor


def supported(config: EchoCanceller3Config) -> bool:
    """Whether the kernel runs this configuration: a coarse filter no longer
    than the refined one (the kernel's window holds the refined filter's
    partitions). ``Aec3Geometry.create`` rejects the pair kernel otherwise."""
    f = config.filter
    return (max(f.coarse.length_blocks, f.coarse_initial.length_blocks)
            <= max(f.refined.length_blocks, f.refined_initial.length_blocks))


def process_pair_kernel(config: EchoCanceller3Config, geo: rb.BufferGeometry,
                        state: subt.SubtractorState, sf_chain, offsets, ys,
                        narrow_masks, poor_excitations, delay_changes,
                        transitions, saturated_capture):
    """``subtractor.process_pair`` on the kernel. sf_chain (B, W2, F) the
    frame's packed sf rows; lists per block: offsets (B,) integer window
    starts in the chain, ys (B, C_cap, 64), narrow_masks (B, 65) bool,
    poor_excitations, delay_changes and transitions (B,) bool;
    saturated_capture (B,) bool. Returns (state, [outputs dict per block])."""
    events = torch.stack([torch.stack(poor_excitations, dim=1),
                          torch.stack(delay_changes, dim=1),
                          torch.stack(transitions, dim=1)], dim=-1)
    new, out = cuda_subtractor.pair(
        config, geo, cuda_subtractor.pack(state), sf_chain,
        torch.stack(offsets, dim=1), torch.stack(ys, dim=1),
        torch.stack(narrow_masks, dim=1), events, saturated_capture)
    outs = []
    for k in range(len(ys)):
        o = {key: out.scalars[:, k, :, j]
             for j, key in enumerate(cuda_subtractor.SCALAR_KEYS)}
        o.update(e_refined=out.e_refined[:, k], e_coarse=out.e_coarse[:, k],
                 refined_frequency_responses=out.freq[:, k],
                 refined_impulse_responses=out.imp[:, k],
                 refined_current_size=out.size[:, k])
        outs.append(o)
    return cuda_subtractor.unpack(new), outs
