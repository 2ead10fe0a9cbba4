"""Count the ops one frame of the hybrid AGC1 path runs, split by module.

Runs ``chip_smoke.agc1_geometry()`` (``Config()``'s pipeline at 48 kHz
stereo with HPF, AEC3, NS and the hybrid AGC1) eagerly on the CPU at a
small batch for one period of the cadence (6 frames: every AEC3 parity
and analytics-VAD phase once) and counts the aten ops each stage
dispatches, with a ``TorchDispatchMode``. Each op is one kernel launch on
the card (one node of the captured graph), give or take the few ops that
are views or that the CUDA build fuses or splits, so this is the node
count by module; ``chip_smoke.py`` phase 11 measures the whole frame's
device kernels on the card.

    python3 tools/torch_agc1_nodes.py          # CPU, ~1 min

Prints one JSON line: ops a frame (the mean over the period) per stage,
and the frame's total.
"""

from __future__ import annotations

import collections
import json
import sys
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from webrtc_audio_processing_tpu_torch import apm  # noqa: E402
from webrtc_audio_processing_tpu_torch.models.agc1 import (  # noqa: E402
    agc_manager_direct as amd,
    analog,
    digital,
    gain_control as gc,
)
from webrtc_audio_processing_tpu_torch.models.vad import (  # noqa: E402
    analytics_vad,
    legacy_vad,
)
from webrtc_audio_processing_tpu_torch.ops import (  # noqa: E402
    cuda_agc1_limiter,
    cuda_biquad,
    cuda_matched_filter,
    cuda_pre_echo,
    cuda_span,
    spl,
)

STACK = ["rest of the step"]
COUNTS = collections.Counter()
KERNEL = "a hand kernel's twin"


class _Count(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if STACK[-1] != KERNEL:
            COUNTS[STACK[-1]] += 1
        return func(*args, **(kwargs or {}))


def _kernel(module, name):
    """On the card a wrapper launches one kernel; on the CPU its twin runs
    many ops: count the call as one, in the stage that makes it."""
    fn = getattr(module, name)

    def wrapped(*a, **k):
        COUNTS[STACK[-1]] += 1
        STACK.append(KERNEL)
        try:
            return fn(*a, **k)
        finally:
            STACK.pop()

    setattr(module, name, wrapped)


def _stage(module, name, label):
    fn = getattr(module, name)

    def wrapped(*a, **k):
        STACK.append(label)
        try:
            return fn(*a, **k)
        finally:
            STACK.pop()

    setattr(module, name, wrapped)


# Innermost first: an op counts toward the innermost stage it runs in.
for module, name, label in (
        (gc, "process_render_audio", "AGC1 far-end VAD (render)"),
        (amd, "analyze_pre_process", "manager: clipping pre-analysis"),
        (analog, "add_mic", "AGC1 AddMic (mic VAD, energy downsampler)"),
        (digital, "compute_digital_gains",
         "AGC1 digital gains (near-end VAD, capacitors, limiter)"),
        (gc, "apply_digital_gain_float", "AGC1 float gain"),
        (amd, "process", "manager: histogram, MonoAgc"),
        (analytics_vad, "extract_features",
         "analytics VAD: features (pitch, LPC, IIRs on K1)"),
        (analytics_vad, "pitch_based_voicing",
         "analytics VAD: pitch-based GMM"),
        (legacy_vad, "process", "analytics VAD: standalone GMM VAD"),
        (spl, "downsample_by_2", "SPL downsampler (all AGC1 VADs)")):
    _stage(module, name, label)
for module, name in ((cuda_biquad, "cascade"), (cuda_span, "span_gather"),
                     (cuda_matched_filter, "nlms"),
                     (cuda_pre_echo, "pre_echo_inst"),
                     (cuda_agc1_limiter, "limit")):
    _kernel(module, name)


def main():
    geo = chip_smoke.agc1_geometry()
    B, period = 4, apm.parity_period(geo)
    render, capture = chip_smoke.echo_scene(2 * period, chip_smoke.SEED,
                                            range(B))
    state = apm.init_state(geo, B, device="cpu")
    module = apm.module_for(geo, torch.device("cpu"))
    volume = torch.full((B,), 100, dtype=torch.int32)
    for f in range(2 * period):
        if f == period:
            COUNTS.clear()
            mode = _Count()
            mode.__enter__()
        sl = slice(f * 480, (f + 1) * 480)
        state, _, _, stats = module(state, torch.from_numpy(capture[:, sl]),
                                    torch.from_numpy(render[:, sl]),
                                    applied_input_volume=volume)
        volume = stats["agc1_recommended_level"]
    mode.__exit__(None, None, None)
    per_frame = {k: v / period for k, v in COUNTS.most_common()}
    print(json.dumps({"ops_per_frame": per_frame,
                      "total": sum(per_frame.values()), "frames": period}))


if __name__ == "__main__":
    main()
