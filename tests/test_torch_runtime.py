"""The port's runtime on the CPU: the native streaming plane's queues
(tests/test_native_runtime.py's cases, through the port's own bindings and
build), and ``BatchEngine`` on the port's eager APM step at B = 4, bit for
bit against direct ``process_stream_pair`` calls, with and without streams
that miss frames."""

import threading

import numpy as np
import pytest
import torch

from tests import torch_threads  # noqa: F401  (one thread a worker)
from webrtc_audio_processing_tpu_torch import apm
from webrtc_audio_processing_tpu_torch import config as cfg_mod
from webrtc_audio_processing_tpu_torch.ops import cuda_build
from webrtc_audio_processing_tpu_torch.runtime import (
    BatchEngine,
    StreamingPlane,
    apm_step_fn,
    streaming,
)


def test_plane_library_is_built_in_the_port_build_directory():
    StreamingPlane(num_streams=1, samples=160)
    path = streaming.library_path()
    assert path.parent == cuda_build.BUILD_DIR and path.exists()
    assert streaming._LIB._name == str(path)


def test_queue_roundtrip_and_ordering():
    plane = StreamingPlane(num_streams=2, samples=160, queue_capacity=8)
    for k in range(5):
        assert plane.push_capture(0, np.full((160, 1), float(k)))
        assert plane.push_render(0, np.full((160, 1), float(10 + k)))
    cap = np.zeros((2, 160, 1), np.float32)
    ren = np.zeros((2, 160, 1), np.float32)
    mask = np.zeros((2,), np.uint8)
    for k in range(5):
        assert plane.collect_batch(cap, ren, mask) == 1
        assert mask[0] == 1 and mask[1] == 0
        assert cap[0, 0, 0] == float(k) and ren[0, 0, 0] == float(10 + k)
        assert cap[1].max() == 0.0  # stream 1's rows are zero-filled
    assert plane.collect_batch(cap, ren, mask) == 0


def test_queue_overflow_drops_and_counts():
    plane = StreamingPlane(num_streams=1, samples=80, queue_capacity=4)
    ok = [plane.push_capture(0, np.zeros((80, 1))) for _ in range(6)]
    assert sum(ok) == 4
    assert plane.dropped(0) == 2 and plane.capture_queue_size(0) == 4


def test_threaded_producers_keep_each_stream_in_order():
    plane = StreamingPlane(num_streams=4, samples=160, queue_capacity=64)
    frames_per_stream = 50

    def producer(sid):
        for k in range(frames_per_stream):
            while not plane.push_capture(sid, np.full((160, 1),
                                                      sid * 1000.0 + k)):
                pass

    threads = [threading.Thread(target=producer, args=(s,))
               for s in range(4)]
    for t in threads:
        t.start()
    cap = np.zeros((4, 160, 1), np.float32)
    ren = np.zeros((4, 160, 1), np.float32)
    mask = np.zeros((4,), np.uint8)
    got = {s: [] for s in range(4)}
    total = 0
    while total < 4 * frames_per_stream:
        total += plane.collect_batch(cap, ren, mask)
        for s in range(4):
            if mask[s]:
                got[s].append(int(cap[s, 0, 0] - s * 1000.0))
    for t in threads:
        t.join()
    for s in range(4):
        assert got[s] == list(range(frames_per_stream))
    assert all(plane.races(s) == 0 for s in range(4))


def test_invalid_geometry_rejected():
    with pytest.raises(ValueError):
        StreamingPlane(num_streams=1, samples=10000)


def test_batch_engine_with_a_torch_step():
    n, samples = 8, 160
    plane = StreamingPlane(n, samples, queue_capacity=8)

    def step(st, cap, ren):
        return st + 1.0, cap * 2.0 + ren

    engine = BatchEngine(plane, step, torch.zeros(n))
    for s in range(n):
        plane.push_capture(s, np.full((samples, 1), 1.0 + s))
        plane.push_render(s, np.full((samples, 1), 0.5))
    assert engine.step() == n
    for s in range(n):
        out = plane.pop_output(s)
        np.testing.assert_allclose(out[0, 0], 2.0 * (1.0 + s) + 0.5)
        assert plane.frames_processed(s) == 1
    assert engine.step() == 0
    assert engine.state.tolist() == [1.0] * n


def test_pending_outputs_each_keep_a_buffer_of_their_own():
    """A step that owns its output and overwrites it on every call (as a
    CUDA graph does): with ``flush_every`` 3 the three pending outputs
    still reach the queues as three different frames."""
    n, samples = 2, 80
    plane = StreamingPlane(n, samples, queue_capacity=8)
    owned = torch.zeros((n, samples, 1))

    def step(st, cap, ren):
        owned.copy_(cap + st)
        return st + 1, owned

    engine = BatchEngine(plane, step, 0, flush_every=3)
    for k in range(3):
        for s in range(n):
            plane.push_capture(s, np.full((samples, 1), 10.0 * k))
    for _ in range(3):
        engine.step()
    got = [plane.pop_output(0)[0, 0] for _ in range(3)]
    assert got == [0.0, 11.0, 22.0]
    assert plane.pop_output(0) is None


def test_step_factory_raises_without_a_card_unless_given_the_cpu():
    geo = apm.ApmGeometry.create(cfg_mod.Config(), 16000)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the factory builds on it")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        apm_step_fn(geo, 2)
    step_fn, state, graphs = apm_step_fn(geo, 2, device="cpu")
    assert graphs is None and state.frame_parity.device.type == "cpu"


# ------------------------------------------------ the engine on the APM


B = 4
RATE = 16000
FRAME = RATE // 100
N_FRAMES = 10


def _geometry():
    c = cfg_mod.Config().replace(
        high_pass_filter=cfg_mod.HighPassFilter(enabled=True),
        echo_canceller=cfg_mod.EchoCanceller(enabled=True),
        noise_suppression=cfg_mod.NoiseSuppression(enabled=True),
        gain_controller2=cfg_mod.GainController2(
            enabled=True,
            adaptive_digital=cfg_mod.AdaptiveDigital(enabled=True)))
    return apm.ApmGeometry.create(c, RATE, 1)


def _scene(seed):
    rng = np.random.default_rng(seed)
    far = (0.2 * rng.standard_normal((N_FRAMES, B, FRAME, 1))).astype(
        np.float32)
    near = (0.4 * np.roll(far, 3, axis=2) + 0.01 * rng.standard_normal(
        far.shape)).astype(np.float32)
    return far, near


@pytest.mark.parametrize("missing", [False, True],
                         ids=["every_frame", "missed_frames"])
def test_batch_engine_on_the_apm_is_bit_equal_to_direct_steps(missing):
    """Frame by frame, each stream pushes its frame (stream 1 misses every
    third when ``missing``) and the engine steps; the direct steps see
    zeros in the missed rows, and each stream's popped outputs are its
    rows of them, bit for bit."""
    geo = _geometry()
    far, near = _scene(3)
    plane = StreamingPlane(B, FRAME, queue_capacity=4)
    step_fn, state, _ = apm_step_fn(geo, B, device="cpu")
    engine = BatchEngine(plane, step_fn, state)
    direct = apm.init_state(geo, B, device="cpu")
    want = {s: [] for s in range(B)}
    got = {s: [] for s in range(B)}
    for f in range(N_FRAMES):
        fed = np.ones(B, bool)
        if missing and f % 3 == 1:
            fed[1] = False
        for s in np.flatnonzero(fed):
            assert plane.push_capture(s, near[f, s])
            assert plane.push_render(s, far[f, s])
        assert engine.step() == fed.sum()
        rows = fed[:, None, None]  # zeros as the plane's memset: +0.0
        direct, out, _, _ = apm.process_stream_pair(
            geo, direct, torch.from_numpy(np.where(rows, near[f], 0.0)),
            torch.from_numpy(np.where(rows, far[f], 0.0)))
        for s in range(B):
            if fed[s]:
                want[s].append(out[s].numpy())
                got[s].append(plane.pop_output(s))
    for s in range(B):
        assert len(got[s]) == plane.frames_processed(s) == len(want[s])
        np.testing.assert_array_equal(np.stack(got[s]), np.stack(want[s]))
        assert plane.dropped(s) == 0
    assert len(got[1]) == (N_FRAMES - 3 if missing else N_FRAMES)
