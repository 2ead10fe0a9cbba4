"""Each kernel launcher refuses a tensor that is not on the current CUDA
device, before it builds or launches anything.

A launcher hands its kernel PyTorch's current stream on the tensor's card
and the kernel runs in the current device's context: a shard on cuda:1
launched while cuda:0 is current would run against the wrong context. So
every ``ops/cuda_*.py`` launcher checks the device
(``cuda_build.check_current_device``) after validating its inputs' shapes
and dtypes and before it touches the kernel library. On the CPU: a CPU
tensor given to a launcher raises, and so does a stand-in tensor on
cuda:1 while the current device is cuda:0 (``torch.cuda.current_device``
patched).
"""

import types

import pytest
import torch

from tests import torch_threads  # noqa: F401  (one thread a worker)
from webrtc_audio_processing_tpu_torch.ops import (
    cuda_agc1_limiter,
    cuda_biquad,
    cuda_build,
    cuda_matched_filter,
    cuda_pre_echo,
    cuda_span,
    cuda_subtractor,
    cuda_window,
)


def _call(name, t):
    """Launcher ``name`` with ``t`` in every tensor argument."""
    if name == "biquad":
        return cuda_biquad.cascade_cuda(t, t, t)
    if name == "span":
        return cuda_span.span_gather_cuda(t, t, 3)
    if name == "matched_filter":
        return cuda_matched_filter.nlms_cuda(t, t, t, t, t, shift=0,
                                             ds_size=16, threshold=0.0)
    if name == "pre_echo":
        return cuda_pre_echo.pre_echo_cuda(t, t, t, t, 4)
    if name == "window":
        return cuda_window.take_windows_cuda(t, t, 3)
    if name == "agc1_limiter":
        return cuda_agc1_limiter.limit_cuda(t, t)
    if name == "subtractor":
        st = cuda_subtractor.PairState(*[t] * len(
            cuda_subtractor.PairState._fields))
        return cuda_subtractor.pair_cuda(None, st, t, t, t, t, t, t)
    raise KeyError(name)


LAUNCHERS = ["biquad", "span", "matched_filter", "pre_echo", "window",
             "agc1_limiter", "subtractor"]


MODULES = [cuda_agc1_limiter, cuda_biquad, cuda_matched_filter,
           cuda_pre_echo, cuda_span, cuda_window]


@pytest.fixture
def no_build(monkeypatch):
    """A launcher that got past its device check would build the library:
    make that fail loudly instead. Each launcher validates shapes and
    dtypes before its device check (tests/test_torch_kernel_contracts.py
    holds that order); here that validation is stubbed, so the stand-in
    tensors reach the device check."""
    def refuse():
        raise AssertionError("the launcher went on to build its kernel")

    monkeypatch.setattr(cuda_build, "library", refuse)
    for m in MODULES:
        monkeypatch.setattr(m, "_check", lambda *a, **k: None)


@pytest.mark.parametrize("name", LAUNCHERS)
def test_launcher_refuses_a_cpu_tensor(no_build, name):
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        _call(name, torch.zeros(4))


@pytest.mark.parametrize("name", LAUNCHERS)
def test_launcher_refuses_a_tensor_of_another_card(no_build, monkeypatch,
                                                   name):
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    other = types.SimpleNamespace(device=torch.device("cuda", 1))
    with pytest.raises(ValueError, match="current CUDA device is cuda:0"):
        _call(name, other)


def test_check_passes_a_tensor_of_the_current_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    cuda_build.check_current_device(
        types.SimpleNamespace(device=torch.device("cuda", 1)))
