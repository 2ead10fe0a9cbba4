"""The port's bench twin (``webrtc_audio_processing_tpu_torch/bench.py``) on
the CPU: its configuration is ``bench.build_step``'s, its batch loop keeps
``bench.py``'s rules with only an out-of-memory error caught, its line has
``bench.py``'s keys, and without a card it refuses to run. The timing
itself runs only on the card (``chip_smoke.py`` phase 8)."""

import pytest
import torch

import chip_smoke

from webrtc_audio_processing_tpu_torch import bench


@pytest.mark.parametrize("mode", ["48k_stereo", "16k_mono"])
@pytest.mark.parametrize("pair_kernel", [False, True])
def test_geometry_is_the_bench_configuration(mode, pair_kernel):
    assert bench.build_geometry(mode, pair_kernel) == (
        chip_smoke.aec3_geometry(mode, pair_kernel))


def test_batch_sizes_and_chunk_are_the_bench_s():
    assert bench.BATCHES == {"48k_stereo": (512, 1024, 2048, 4096, 8192),
                             "16k_mono": (1024, 4096, 8192, 16384)}
    assert bench.CHUNK_PAIRS == 25


def test_bf16_rings_raise_not_implemented(monkeypatch):
    monkeypatch.setenv("BENCH_RING_DTYPE", "bfloat16")
    with pytest.raises(NotImplementedError):
        bench.build_geometry("48k_stereo", False)


def _fake(ms, fail=None, error=None):
    """A batch runner with the given ms/frame per batch size that raises
    ``error`` at batch size ``fail``."""
    ran = []

    def run(n):
        ran.append(n)
        if n == fail:
            raise error
        return dict(seconds_per_frame=ms[n] / 1e3, capture_seconds=0.5)

    return run, ran


def test_out_of_memory_skips_that_batch_and_every_larger_one():
    ms = {512: 5.0, 1024: 6.0, 2048: 16.0, 4096: 12.0, 8192: 20.0}
    run, ran = _fake(ms, fail=4096,
                     error=torch.cuda.OutOfMemoryError("out of memory"))
    best, results = bench.measure_streams("48k_stereo", 1e9, tuple(ms), run)
    assert ran == [512, 1024, 2048, 4096]
    assert sorted(results) == [512, 1024, 2048]
    assert best == int(2048 * 10.0 / 16.0) == results[2048]["streams"]
    assert results[2048]["capture_seconds"] == 0.5


def test_any_other_error_propagates():
    ms = {1024: 5.0, 4096: 6.0}
    run, _ = _fake(ms, fail=4096, error=RuntimeError("capture failed"))
    with pytest.raises(RuntimeError, match="capture failed"):
        bench.measure_streams("16k_mono", 1e9, tuple(ms), run)


def test_streams_are_capped_at_the_batch_and_the_loop_stops_on_a_fall():
    """streams = B x min(10 ms / t, 1); the loop stops once streams fall to
    90% of the best (bench.py:226)."""
    ms = {512: 2.0, 1024: 4.0, 2048: 30.0, 4096: 10.0}
    run, ran = _fake(ms)
    best, results = bench.measure_streams("48k_stereo", 1e9, tuple(ms), run)
    assert results[512]["streams"] == 512
    assert results[1024]["streams"] == 1024
    assert ran == [512, 1024, 2048] and best == 1024


def test_budget_ends_the_loop_once_a_result_exists():
    ms = {512: 5.0, 1024: 5.0}
    run, ran = _fake(ms)
    best, _ = bench.measure_streams("48k_stereo", -1.0, tuple(ms), run)
    assert ran == [512] and best == 512


def test_result_line_has_the_bench_keys_and_the_card_s():
    results = {"48k_stereo": {2048: dict(seconds_per_frame=0.025,
                                         streams=819, peak_memory_gb=9.5)}}
    line = bench.result_line(819, None, results, "NVIDIA H100, 700.00 W",
                             True)
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "card",
                         "subtractor", "ms_per_frame", "batches"}
    assert line["value"] == 819 and line["unit"] == "streams"
    assert line["vs_baseline"] == 819 / 10000.0
    assert line["subtractor"] == "k6"
    assert line["ms_per_frame"] == {"48k_stereo": {"2048": 25.0}}
    assert line["batches"]["48k_stereo"]["2048"] == dict(
        streams=819, peak_memory_gb=9.5)
    line = bench.result_line(0, 300, {}, "card", False)
    assert line["secondary_16k_mono_streams"] == 300
    assert line["subtractor"] == "plain"


def test_main_refuses_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        bench.main()
    assert exc.value.code not in (0, None)
