"""Count the ops one frame of the mobile path runs, split by module.

Runs ``chip_smoke.aecm_geometry(16000)`` (the reference's fixed profile:
HPF, NS, AECM in mobile mode and AGC1 adaptive digital at 16 kHz mono)
eagerly on the CPU at a small batch, past AECM's startup, and counts the
aten ops each stage dispatches with a ``TorchDispatchMode``. Each op is
one kernel launch on the card (one node of the captured graph), give or
take the few ops that are views or that the CUDA build fuses or splits, so
this is the node count by module; ``chip_smoke.py``'s ``aecm_fixed_16k``
phase measures the whole frame's device kernels on the card. Inside
``aecm.core.process_block`` the ops are split by the reference's sections,
read off the comment that opens each section in the source.

    python3 tools/torch_aecm_nodes.py          # CPU, ~30 s

Prints one JSON line: ops a frame (the mean over the counted frames) per
stage, and the frame's total.
"""

from __future__ import annotations

import collections
import inspect
import json
import sys
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from webrtc_audio_processing_tpu_torch import apm  # noqa: E402
from webrtc_audio_processing_tpu_torch.models import (  # noqa: E402
    noise_suppressor as ns,
)
from webrtc_audio_processing_tpu_torch.models.aecm import (  # noqa: E402
    core,
    echo_control_mobile as ecm,
)
from webrtc_audio_processing_tpu_torch.models.agc1 import (  # noqa: E402
    digital,
    gain_control as gc,
)
from webrtc_audio_processing_tpu_torch.ops import (  # noqa: E402
    cuda_agc1_limiter,
    cuda_biquad,
    int_fft,
)

STACK = ["rest of the step"]
COUNTS = collections.Counter()
KERNEL = "a hand kernel's twin"
BLOCK = "AECM process_block"

# process_block's sections, by the comment that opens each.
_SECTIONS = (("startup", "block buffers"),
             ("# Far history and the delay estimate", "far history"),
             ("# CalcEnergies", "energies and far VAD"),
             ("# CalcStepSize", "step size"),
             ("# UpdateChannel", "channel update (NLMS)"),
             ("# Store and reset decisions", "channel store and reset"),
             ("# CalcSuppressionGain", "suppression gain"),
             ("# The Wiener-like NLP gain", "NLP (Wiener gain)"),
             ("# InverseFFTAndWindow", "inverse FFT and overlap-add"))


def _section_starts():
    lines, first = inspect.getsourcelines(core.process_block)
    starts = []
    for marker, label in _SECTIONS:
        at = next(i for i, line in enumerate(lines) if marker in line)
        starts.append((first + at, f"{BLOCK}: {label}"))
    return starts


STARTS = _section_starts()
_BLOCK_CODE = core.process_block.__code__  # before the stages wrap it


def _block_section():
    """The section of process_block the op was called from, if any."""
    frame = sys._getframe(2)
    while frame is not None:
        if frame.f_code is _BLOCK_CODE:
            label = STARTS[0][1]
            for line, name in STARTS:
                if frame.f_lineno >= line:
                    label = name
            return label
        frame = frame.f_back
    return None


class _Count(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        top = STACK[-1]
        if top != KERNEL:
            if top == BLOCK:
                top = _block_section() or top
            COUNTS[top] += 1
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
        (ecm, "buffer_farend", "AECM far-end FIFO (render)"),
        (ecm, "_startup_step", "AECM startup state machine"),
        (ecm, "_enabled_step", "AECM frame wrapper (FIFO, rebuffer, rings)"),
        (core, "process_block", BLOCK),
        (core, "time_to_frequency", "AECM time to frequency (int FFT)"),
        (core, "delay_estimator_process", "AECM binary delay estimator"),
        (int_fft, "real_inverse_fft_i16", "AECM inverse int FFT"),
        (ns.NoiseSuppressor, "analyze", "NS analyze"),
        (ns.NoiseSuppressor, "process", "NS process"),
        (gc, "analyze_capture_audio", "AGC1 analysis (virtual mic)"),
        (digital, "compute_digital_gains", "AGC1 digital gains"),
        (gc, "apply_digital_gain_float", "AGC1 float gain")):
    _stage(module, name, label)
for module, name in ((cuda_biquad, "cascade"), (cuda_agc1_limiter, "limit")):
    _kernel(module, name)


def main():
    geo = chip_smoke.aecm_geometry(16000)
    B, warm, counted = 4, 12, 4
    render, capture = chip_smoke.aecm_scene(warm + counted, 16000, range(B))
    state = apm.init_state(geo, B, device="cpu")
    module = apm.module_for(geo, torch.device("cpu"))
    delay = torch.full((B,), chip_smoke.AECM_DELAY_MS, dtype=torch.int32)
    mode = None
    for f in range(warm + counted):
        if f == warm:
            if bool(state.aecm.ec_startup.any()):
                raise SystemExit("AECM is still in startup: count later")
            COUNTS.clear()
            mode = _Count()
            mode.__enter__()
        sl = slice(f * 160, (f + 1) * 160)
        state, _, _, _ = module(state, torch.from_numpy(capture[:, sl]),
                                torch.from_numpy(render[:, sl]),
                                stream_delay_ms=delay)
    mode.__exit__(None, None, None)
    per_frame = {k: v / counted for k, v in COUNTS.most_common()}
    print(json.dumps({"ops_per_frame": per_frame,
                      "total": sum(per_frame.values()), "frames": counted}))


if __name__ == "__main__":
    main()
