"""Call order of the port's pipeline, independent of numerics: the seams
of tests/test_orchestration_seams.py that apply to the port (the capture
chain's order, the 48 kHz HPF rate pairing, the render consumers fed before
capture). Each seam is wrapped with a recorder that logs the call and
delegates to the real implementation, so a reordering shows even where it
happens to be numerically benign."""

import numpy as np
import torch

from tests import torch_threads  # noqa: F401  (one thread a worker)
from webrtc_audio_processing_tpu_torch import apm
from webrtc_audio_processing_tpu_torch import config as cfg_mod
from webrtc_audio_processing_tpu_torch.models import (
    echo_detector as ed_mod,
    high_pass_filter as hpf_mod,
    noise_suppressor as ns_mod,
)
from webrtc_audio_processing_tpu_torch.models.aec3 import (
    echo_canceller3 as ec3_mod,
)
from webrtc_audio_processing_tpu_torch.models.agc2 import (
    gain_controller2 as gc2_mod,
)

RNG = np.random.default_rng(5)


def _record(monkeypatch, calls, owner, name, tag, static=None):
    """Wrap ``owner.name`` (a module function or a class's method) with a
    recorder that logs (tag[, static(args)]) and delegates."""
    real = getattr(owner, name)

    def wrapper(*args, **kwargs):
        entry = [tag]
        if static is not None:
            entry.append(static(*args, **kwargs))
        calls.append(tuple(entry))
        return real(*args, **kwargs)

    monkeypatch.setattr(owner, name, wrapper)


def _frames(rate, cap_ch, ren_ch, batch=2):
    F = rate // 100
    cap = RNG.standard_normal((batch, F, cap_ch)).astype(np.float32) * 0.1
    ren = RNG.standard_normal((batch, F, ren_ch)).astype(np.float32) * 0.1
    return torch.from_numpy(cap), torch.from_numpy(ren)


def test_desktop_capture_call_order(monkeypatch):
    """HPF -> GC2.Analyze -> NS.Analyze -> AEC3 -> NS.Process ->
    GC2.Process, one call each per frame (ProcessCaptureStreamLocked
    :1282-1477, desktop branch); the full-band HPF at the 32 kHz
    processing rate."""
    c = cfg_mod.Config().replace(
        high_pass_filter=cfg_mod.HighPassFilter(enabled=True),
        echo_canceller=cfg_mod.EchoCanceller(enabled=True),
        noise_suppression=cfg_mod.NoiseSuppression(enabled=True),
        gain_controller2=cfg_mod.GainController2(
            enabled=True,
            adaptive_digital=cfg_mod.AdaptiveDigital(enabled=True),
            input_volume_controller=cfg_mod.InputVolumeController(
                enabled=True)),
    )
    geo = apm.ApmGeometry.create(c, 32000, 1, render_input_rate=32000,
                                 num_render_channels=1)
    state = apm.init_state(geo, 2, device="cpu")
    calls = []
    _record(monkeypatch, calls, hpf_mod.HighPassFilter, "forward", "hpf",
            static=lambda self, st, y: self.sample_rate_hz)
    _record(monkeypatch, calls, ns_mod.NoiseSuppressor, "analyze",
            "ns.analyze")
    _record(monkeypatch, calls, ns_mod.NoiseSuppressor, "process",
            "ns.process")
    _record(monkeypatch, calls, ec3_mod, "process_frame", "aec3")
    _record(monkeypatch, calls, gc2_mod, "analyze", "gc2.analyze")
    _record(monkeypatch, calls, gc2_mod.GainController2, "forward",
            "gc2.process")
    cap, ren = _frames(32000, 1, 1)
    apm.process_stream_pair(geo, state, cap, ren, applied_input_volume=100)
    names = [e[0] for e in calls]
    assert names == ["hpf", "gc2.analyze", "ns.analyze", "aec3",
                     "ns.process", "gc2.process"], names
    assert calls[0][1] == 32000


def test_hpf_rate_pairing_48k_output(monkeypatch):
    """Processing at 32 kHz (NS splits bands, the internal rate is capped
    at 32 kHz) with a 48 kHz output selects the reference's 48 kHz HPF
    coefficients (InitializeHighPassFilter :1891-1896)."""
    c = cfg_mod.Config().replace(
        pipeline=cfg_mod.Pipeline(maximum_internal_processing_rate=32000),
        high_pass_filter=cfg_mod.HighPassFilter(enabled=True),
        noise_suppression=cfg_mod.NoiseSuppression(enabled=True))
    geo = apm.ApmGeometry.create(c, 48000, 1)
    state = apm.init_state(geo, 2, device="cpu")
    calls = []
    _record(monkeypatch, calls, hpf_mod.HighPassFilter, "forward", "hpf",
            static=lambda self, st, y: (self.sample_rate_hz, y.shape[1]))
    cap, _ = _frames(48000, 1, 1)
    apm.process_stream_pair(geo, state, cap)
    # 48 kHz coefficients on the 32 kHz buffer's 320 samples.
    assert calls == [("hpf", (48000, 320))]


def test_render_consumers_fed_before_capture(monkeypatch):
    """The whole render half, the echo detector's render analysis in it,
    runs before any capture-side processing (EmptyQueuedRenderAudioLocked
    at :1265, first in ProcessCaptureStreamLocked)."""
    c = cfg_mod.Config().replace(
        echo_canceller=cfg_mod.EchoCanceller(enabled=True),
        noise_suppression=cfg_mod.NoiseSuppression(enabled=True))
    geo = apm.ApmGeometry.create(c, 16000, 1, render_input_rate=16000,
                                 num_render_channels=1)
    state = apm.init_state(geo, 2, device="cpu")
    calls = []
    _record(monkeypatch, calls, apm.Apm, "process_render_stream", "render")
    _record(monkeypatch, calls, ed_mod, "analyze_render_audio", "ed.render")
    _record(monkeypatch, calls, ns_mod.NoiseSuppressor, "analyze",
            "ns.analyze")
    _record(monkeypatch, calls, ec3_mod, "process_frame", "aec3")
    _record(monkeypatch, calls, ed_mod, "analyze_capture_audio",
            "ed.capture")
    cap, ren = _frames(16000, 1, 1)
    apm.process_stream_pair(geo, state, cap, ren)
    assert [e[0] for e in calls] == ["render", "ed.render", "ns.analyze",
                                     "aec3", "ed.capture"]


def test_a_fabricated_render_frame_does_not_feed_the_echo_detector(
        monkeypatch):
    """``render_valid`` False: the render half runs (AEC3 still sees the
    silent frame) but its queue consumer, the echo detector, is not fed
    (apm.py:480-486 of the JAX package)."""
    c = cfg_mod.Config().replace(
        echo_canceller=cfg_mod.EchoCanceller(enabled=True))
    geo = apm.ApmGeometry.create(c, 16000, 1)
    state = apm.init_state(geo, 2, device="cpu")
    calls = []
    _record(monkeypatch, calls, ed_mod, "analyze_render_audio", "ed.render")
    _record(monkeypatch, calls, ec3_mod, "process_frame", "aec3")
    cap, ren = _frames(16000, 1, 1)
    new, _, _, _ = apm.process_stream_pair(geo, state, cap, 0 * ren,
                                           render_valid=False)
    assert [e[0] for e in calls] == ["aec3"]
    assert torch.equal(new.ed.rb_size, state.ed.rb_size)
    # Per stream: only the rows marked valid feed it.
    new, _, _ = apm.process_render_stream(
        geo, state, ren, feed_valid=torch.tensor([True, False]))
    assert new.ed.rb_size.tolist() == [1, 0]
