"""The port's builder, field trials and injection seams against the JAX
package on the CPU: the tests of tests/test_builder_injection.py run
through both packages, each injected component written once in jnp and
once in torch; ``adjust_aec3_config`` for every trial it reads; the
echo-control factory, the echo detector, the neural residual echo
estimator and AEC3's debug taps through both APIs at 16 kHz mono; and the
state walkers on an injected component's dicts and tuples.

The two AEC3 runs (the built-in AEC3 with every other injection, and an
injected echo control) are module-scoped: each package's API compiles or
builds its steps once for all of their tests.
"""

import concurrent.futures
import dataclasses
import inspect
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webrtc_audio_processing_tpu import api as j_api
from webrtc_audio_processing_tpu import builder as j_builder
from webrtc_audio_processing_tpu import config as j_cfg
from webrtc_audio_processing_tpu import field_trials as j_ft
from webrtc_audio_processing_tpu.models import echo_detector as j_ed
from webrtc_audio_processing_tpu.models.aec3 import (
    config as j_a3cfg,
    echo_canceller3 as j_ec3,
)
from webrtc_audio_processing_tpu.utils import complex_boundary

import chip_smoke
import webrtc_audio_processing_tpu_torch as port
from webrtc_audio_processing_tpu_torch import api, apm, builder, step_graph
from webrtc_audio_processing_tpu_torch import config as cfg_mod
from webrtc_audio_processing_tpu_torch import field_trials as ft
from webrtc_audio_processing_tpu_torch.models import echo_detector as ed
from webrtc_audio_processing_tpu_torch.models.aec3 import config as a3cfg

from tests.torch_aec3_setup import assert_states_close, flat

RATE = 16000
FRAME = RATE // 100
PACKAGES = {"jax": (j_ft, j_a3cfg, j_builder, j_cfg),
            "torch": (ft, a3cfg, builder, cfg_mod)}
# The states through the two APIs: integer and boolean leaves exact, float
# leaves within 1e-3 of each leaf's scale (the BASELINE.md bar's order).
# The API path carries the HPF's float noise between the packages (3.6e-5
# of hpf.filt.y's scale after frame 1 at 16 kHz, with no injection at all)
# into AEC3's capture decimator, an IIR whose state then differs by 2.9e-4
# of its scale, and NS's analysis spectrum by 1.4e-4 in one bin.
STATE_RTOL = 1e-3


def _frames(n, channels=1, seed=0, scale=0.1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, FRAME, channels)).astype(np.float32) * scale


def _tree(cfg):
    """{dotted field: value} of a config tree."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            out.update({f"{f.name}.{k}": w for k, w in _tree(v).items()})
        else:
            out[f.name] = v
    return out


def _build(name, config, setup=lambda b: b):
    """An AudioProcessing of package ``name`` from its builder, ``setup``
    applied to the builder first; the port's on the CPU."""
    _, _, bld, _ = PACKAGES[name]
    b = setup(bld.AudioProcessingBuilder(config))
    return b.build() if name == "jax" else b.build(device="cpu")


# ------------------------------------------------------------- field trials


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_field_trial_string_parsing(pkg):
    m = PACKAGES[pkg][0]
    t = m.FieldTrials("WebRTC-Aec3OnsetDetectionKillSwitch/Enabled/"
                      "WebRTC-Aec3ConservativeTailFreqResponse/Disabled/")
    assert t.is_enabled("WebRTC-Aec3OnsetDetectionKillSwitch")
    assert t.is_disabled("WebRTC-Aec3ConservativeTailFreqResponse")
    assert not t.is_enabled("WebRTC-Aec3ShortHeadroomKillSwitch")
    assert t.lookup("WebRTC-Missing") == ""


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_field_trial_invalid_strings(pkg):
    m = PACKAGES[pkg][0]
    with pytest.raises(ValueError):
        m.FieldTrials("Odd/")
    with pytest.raises(ValueError):
        m.FieldTrials("A/Enabled/", strict=True)  # unregistered key


def test_registered_trials_equal_jax():
    assert ft.REGISTERED_FIELD_TRIALS == j_ft.REGISTERED_FIELD_TRIALS


def _adjusted(pkg, trials, base="default"):
    m_ft, m_a3, _, _ = PACKAGES[pkg]
    cfg = (m_a3.EchoCanceller3Config() if base == "default"
           else m_a3.create_default_multichannel_config())
    return m_ft.adjust_aec3_config(cfg, m_ft.FieldTrials(trials))


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_adjust_config_kill_switches(pkg):
    trials = ("WebRTC-Aec3OnsetDetectionKillSwitch/Enabled/"
              "WebRTC-Aec3UseDot3SecondsInitialStateDuration/Enabled/"
              "WebRTC-Aec3EchoSaturationDetectionKillSwitch/Enabled/"
              "WebRTC-Aec3ShortHeadroomKillSwitch/Enabled/")
    c = _adjusted(pkg, trials)
    assert c.erle.onset_detection is False
    assert c.filter.initial_state_seconds == pytest.approx(0.3)
    assert c.ep_strength.echo_can_saturate is False
    assert c.delay.delay_headroom_samples == 128
    assert _tree(c) == _tree(_adjusted("jax", trials))


_PARAM_TRIALS = {
    "WebRTC-Aec3UseNearendReverbLen":
        "Enabled-default_len:0.6,nearend_len:-0.5",
    "WebRTC-Aec3SuppressorTuningOverride":
        "Enabled-normal_tuning_max_inc_factor:4.0,"
        "dominant_nearend_detection_trigger_threshold:5",
}


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_adjust_config_param_trials(pkg):
    c = _adjusted(pkg, dict(_PARAM_TRIALS))
    assert c.ep_strength.default_len == pytest.approx(0.6)
    assert c.ep_strength.nearend_len == pytest.approx(-0.5)
    assert c.suppressor.normal_tuning.max_inc_factor == pytest.approx(4.0)
    assert c.suppressor.dominant_nearend_detection.trigger_threshold == 5
    assert _tree(c) == _tree(_adjusted("jax", dict(_PARAM_TRIALS)))


# Every trial the JAX package's adjust_aec3_config reads, from its source.
_READ_TRIALS = sorted(set(re.findall(
    r'"(WebRTC-Aec3[A-Za-z0-9]+)"',
    inspect.getsource(j_ft.adjust_aec3_config))))
_OVERRIDE_ALL = ",".join(
    f"{p}_tuning_{k}:{v}" for p in ("normal", "nearend")
    for k, v in (("mask_lf_enr_transparent", 0.25),
                 ("mask_lf_enr_suppress", 0.75),
                 ("mask_hf_enr_transparent", 0.15),
                 ("mask_hf_enr_suppress", 0.55),
                 ("max_inc_factor", 3.0), ("max_dec_factor_lf", 0.1))
) + (",dominant_nearend_detection_enr_threshold:0.3,"
     "dominant_nearend_detection_enr_exit_threshold:8.0,"
     "dominant_nearend_detection_snr_threshold:20.0,"
     "dominant_nearend_detection_hold_duration:40,"
     "dominant_nearend_detection_trigger_threshold:7")


def _trial_cases():
    cases = []
    for key in _READ_TRIALS:
        for group in ("Enabled", "Disabled"):
            cases.append(pytest.param(key, group, id=f"{key[11:]}-{group}"))
    cases.append(pytest.param(
        "WebRTC-Aec3UseNearendReverbLen",
        "Enabled-default_len:2.0,nearend_len:0.3", id="ReverbLen-outside"))
    cases.append(pytest.param(
        "WebRTC-Aec3SuppressorTuningOverride", "Enabled-" + _OVERRIDE_ALL,
        id="SuppressorTuningOverride-all"))
    return cases


@pytest.mark.parametrize("key,group", _trial_cases())
def test_adjust_config_matches_jax_for_every_read_trial(key, group):
    """Field for field on the default config and on the default
    multichannel one."""
    assert key in j_ft.REGISTERED_FIELD_TRIALS
    for base in ("default", "multichannel"):
        got = _adjusted("torch", {key: group}, base)
        want = _adjusted("jax", {key: group}, base)
        assert _tree(got) == _tree(want), (key, group, base)


def test_read_trials_cover_the_adjustments():
    """The source scan found the trials: 40 and more keys."""
    assert len(_READ_TRIALS) >= 40, _READ_TRIALS


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_builder_applies_field_trials(pkg):
    ap = _build(pkg, PACKAGES[pkg][3].Config(), lambda b: b.set_field_trials(
        "WebRTC-Aec3UseZeroInitialStateDuration/Enabled/"))
    assert ap._aec3_config.filter.initial_state_seconds == 0.0


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_builder_takes_the_estimators_configuration(pkg):
    """With no AEC3 config set, the NREE's get_configuration supplies it
    (with the multichannel flag of the pipeline), then the field trials
    adjust it."""
    m_ft, m_a3, m_b, m_cfg = PACKAGES[pkg]
    asked = []

    def get_configuration(multi):
        asked.append(multi)
        c = m_a3.EchoCanceller3Config()
        return c.replace(delay=dataclasses.replace(
            c.delay, delay_headroom_samples=64))

    nree = m_b.NeuralResidualEchoEstimator(
        estimate=lambda *a: a[4:6], get_configuration=get_configuration)
    config = m_cfg.Config().replace(
        pipeline=m_cfg.Pipeline(multi_channel_capture=True))
    ap = _build(pkg, config, lambda b: b.set_neural_residual_echo_estimator(
        nree).set_field_trials("WebRTC-Aec3OnsetDetectionKillSwitch/Enabled/"))
    assert asked == [True]
    assert ap._aec3_config.delay.delay_headroom_samples == 64
    assert ap._aec3_config.erle.onset_detection is False


def test_package_exports_the_builder():
    assert port.AudioProcessingBuilder is builder.AudioProcessingBuilder
    assert port.BuiltinAudioProcessingBuilder is builder.AudioProcessingBuilder
    assert port.FieldTrials is ft.FieldTrials
    assert port.AudioProcessing is api.AudioProcessing
    assert not builder.Injections()
    assert builder.Injections(capture_analyzer=object())


# ------------------------------------------------------- custom processing


def _gain_processor(pkg, gain):
    if pkg == "jax":
        return j_builder.CustomProcessing(
            init=lambda rate, ch: {"applied": jnp.zeros(())},
            process=lambda st, frame: ({"applied": st["applied"] + 1},
                                       frame * gain))
    return builder.CustomProcessing(
        init=lambda rate, ch, b, dev: {"applied": torch.zeros(b,
                                                              device=dev)},
        process=lambda st, frame: ({"applied": st["applied"] + 1},
                                   frame * gain))


def _frame_counter(pkg, seen):
    if pkg == "jax":
        def init(rate, ch):
            seen["init"] += 1
            return {"count": jnp.zeros((), jnp.int32)}

        return j_builder.CustomAudioAnalyzer(
            init=init, analyze=lambda st, frame: {"count": st["count"] + 1})

    def init_t(rate, ch, b, dev):
        seen["init"] += 1
        return {"count": torch.zeros(b, dtype=torch.int32, device=dev)}

    return builder.CustomAudioAnalyzer(
        init=init_t, analyze=lambda st, frame: {"count": st["count"] + 1})


def _state_numpy(pkg, ap):
    """The API's state as {key path: numpy}, batch first."""
    if pkg == "jax":
        tree = complex_boundary.decode(ap._state)
        return {k: np.asarray(v)[None] for k, v in flat(tree).items()}
    return apm.state_to_numpy(ap._state)


def test_injected_capture_post_processing_applies():
    c = {p: PACKAGES[p][3].Config() for p in PACKAGES}  # all off
    x = _frames(3, seed=1)
    outs = {}
    for pkg in PACKAGES:
        ap = _build(pkg, c[pkg],
                    lambda b, p=pkg: b.set_capture_post_processing(
                        _gain_processor(p, 0.5)))
        ref = _build(pkg, c[pkg])
        outs[pkg] = []
        for f in x:
            err, y = ap.process_stream(f, RATE)
            assert err == 0
            _, y_ref = ref.process_stream(f, RATE)
            np.testing.assert_allclose(y, y_ref * 0.5, rtol=1e-6, atol=1e-7)
            outs[pkg].append(np.asarray(y))
        assert _state_numpy(pkg, ap)["custom_capture_post['applied']"] == 3
    np.testing.assert_allclose(np.stack(outs["torch"]), np.stack(outs["jax"]),
                               rtol=1e-6, atol=1e-7)


def test_injected_render_pre_processing_modifies_render_out():
    r = _frames(1, seed=2)[0]
    got = {}
    for pkg in PACKAGES:
        ap = _build(pkg, PACKAGES[pkg][3].Config(),
                    lambda b, p=pkg: b.set_render_pre_processing(
                        _gain_processor(p, 2.0)))
        # Initialize through one capture frame so that the geometry exists.
        ap.process_stream(_frames(1, seed=3)[0], RATE)
        err, r_out = ap.process_reverse_stream(r, RATE)
        assert err == 0
        _, y = ap.process_stream(_frames(1, seed=4)[0], RATE)
        assert np.isfinite(y).all()
        got[pkg] = (np.asarray(r_out), np.asarray(y),
                    _state_numpy(pkg, ap)["custom_render_pre['applied']"])
    # The processed render is the pre-processor's output, twice the input.
    np.testing.assert_allclose(got["torch"][0], 2.0 * r, rtol=1e-6)
    for g, w in zip(got["torch"], got["jax"]):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)


def test_injected_capture_analyzer_state_advances():
    for pkg in PACKAGES:
        seen = {"init": 0}
        ap = _build(pkg, PACKAGES[pkg][3].Config(),
                    lambda b, p=pkg: b.set_capture_analyzer(
                        _frame_counter(p, seen)))
        for f in _frames(4, seed=5):
            ap.process_stream(f, RATE)
        assert seen["init"] == 1
        assert int(np.asarray(ap._state.custom_analyzer["count"]).sum()) == 4


def test_injected_states_match_jax_leaf_by_leaf():
    """All three host-side seams at once with NS, 4 frames with render:
    every leaf of the two states after frame 1, the injected ones
    included, through ``state_to_numpy`` and the JAX pytree's key paths;
    the injected counters after the last frame."""
    states, last = {}, {}
    for pkg in PACKAGES:
        seen = {"init": 0}
        ap = _build(pkg, PACKAGES[pkg][3].Config().replace(
            noise_suppression=PACKAGES[pkg][3].NoiseSuppression(enabled=True)),
            lambda b, p=pkg, s=seen: b.set_capture_analyzer(
                _frame_counter(p, s)).set_capture_post_processing(
                _gain_processor(p, 0.5)).set_render_pre_processing(
                _gain_processor(p, 2.0)))
        for k, (r, c) in enumerate(zip(_frames(4, seed=8),
                                       _frames(4, seed=9))):
            ap.process_reverse_stream(r, RATE)
            ap.process_stream(c, RATE)
            if k == 1:
                states[pkg] = _state_numpy(pkg, ap)
        last[pkg] = _state_numpy(pkg, ap)
    got, want = states["torch"], states["jax"]
    for k in ("custom_analyzer['count']", "custom_capture_post['applied']",
              "custom_render_pre['applied']"):
        assert k in got
        np.testing.assert_array_equal(last["torch"][k], [4])
        np.testing.assert_array_equal(last["torch"][k], last["jax"][k])
    assert_states_close(got, want, rtol=STATE_RTOL)


def test_render_runtime_settings_reach_the_pre_processor():
    for pkg, m_api in (("jax", j_api), ("torch", api)):
        seen = []
        proc = _gain_processor(pkg, 1.0)
        proc = dataclasses.replace(proc, set_runtime_setting=seen.append)
        ap = _build(pkg, PACKAGES[pkg][3].Config(),
                    lambda b, p=proc: b.set_render_pre_processing(p))
        setting = m_api.RuntimeSetting.create_custom_render_setting(7)
        assert ap.set_runtime_setting(setting)
        assert seen == [setting]


# --------------------------------------- AEC3 with injections, both APIs


def _nree(pkg, calls):
    """An estimator that records its inputs' shapes and returns a flat
    1e-3 residual."""
    def estimate(render, y, e, S2, Y2, E2, dominant_nearend):
        calls.append(tuple(tuple(a.shape) for a in
                           (render, y, e, S2, Y2, E2, dominant_nearend)))
        ones = jnp.ones_like(Y2) if pkg == "jax" else torch.ones_like(Y2)
        return ones * 1e-3, ones * 1e-3

    m_b = PACKAGES[pkg][2]
    return m_b.NeuralResidualEchoEstimator(estimate=estimate)


def _builtin_detector(pkg):
    m, m_b = (j_ed, j_builder) if pkg == "jax" else (ed, builder)
    return m_b.EchoDetectorInjection(
        init=m.init_state, analyze_render_audio=m.analyze_render_audio,
        analyze_capture_audio=m.analyze_capture_audio,
        get_metrics=m.get_metrics)


class _JaxAec3Control:
    """The JAX package's AEC3 behind its EchoControl contract (the port's
    ``echo_canceller3.EchoControl`` in jnp): the block ordinal in the
    state."""

    def __init__(self, geo):
        self.geo = geo

    def init_state(self):
        return {"aec": j_ec3.init_state(self.geo),
                "n0": jnp.zeros((), jnp.int32)}

    def process_frame(self, state, render_bands, capture_bands, parity):
        aec, out, linear = j_ec3.process_frame(
            self.geo, state["aec"], render_bands, capture_bands, parity,
            n0=state["n0"])[:3]
        return ({"aec": aec, "n0": state["n0"] + (3 if parity else 2)}, out,
                linear)

    def get_metrics(self, state):
        return j_ec3.get_metrics(self.geo, state["aec"])


def _echo_control_factory(pkg):
    if pkg == "torch":
        return builder.aec3_echo_control_factory()

    def create(rate, num_render, num_capture):
        cfg, _ = j_a3cfg.validate(j_a3cfg.EchoCanceller3Config())
        return _JaxAec3Control(j_ec3.Aec3Geometry.create(
            cfg, rate, num_render, num_capture, pair_phase=True,
            pair_kernel=False))

    return j_builder.EchoControlFactory(create=create)


AEC3_FRAMES = 3
STATE_FRAME = 1  # the states are compared after this frame
TRIALS = "WebRTC-Aec3OnsetDetectionKillSwitch/Enabled/"


def _aec3_run(pkg, setup, tmp, frames=AEC3_FRAMES, taps=False):
    """Reverse then capture for ``frames`` frames of the JAX test's noise
    (seeds 6 and 7). Returns outputs, stats, the state after frame 1 and
    after the last, and the taps."""
    m_cfg = PACKAGES[pkg][3]
    config = m_cfg.Config().replace(
        echo_canceller=m_cfg.EchoCanceller(enabled=True))
    ap = _build(pkg, config, setup)
    if taps:
        ap.attach_data_dumper(str(tmp))
    out = {"out": [], "render_out": [], "stats": [], "linear": []}
    for k, (cap, ren) in enumerate(zip(_frames(frames, seed=6),
                                       _frames(frames, seed=7))):
        err, rout = ap.process_reverse_stream(ren, RATE)
        assert err == 0
        err, y = ap.process_stream(cap, RATE)
        assert err == 0
        out["out"].append(np.asarray(y))
        out["render_out"].append(np.asarray(rout))
        out["stats"].append(vars(ap.get_statistics()))
        out["linear"].append(np.asarray(ap.get_linear_aec_output()))
        if k == STATE_FRAME:
            out["state"] = _state_numpy(pkg, ap)
    out["last_state"] = _state_numpy(pkg, ap)
    if taps:
        ap.detach_data_dumper()
        out["taps"] = {f[:-4]: np.load(os.path.join(tmp, f))
                       for f in sorted(os.listdir(tmp))}
    out["ap"] = ap
    return out


def _with_everything(pkg, calls):
    def setup(b):
        return (b.set_field_trials(TRIALS)
                .set_neural_residual_echo_estimator(_nree(pkg, calls))
                .set_echo_detector(_builtin_detector(pkg))
                .set_capture_post_processing(_gain_processor(pkg, 0.5))
                .set_render_pre_processing(_gain_processor(pkg, 2.0))
                .set_capture_analyzer(_frame_counter(pkg, {"init": 0})))

    return setup


@pytest.fixture(scope="module")
def api_runs(tmp_path_factory):
    """Five runs side by side, so that the JAX package's two APIs compile
    their steps at once:
    - ``injected_{jax,torch}``: AEC3 with the NREE, the echo detector made
      of the built-in one's functions, the capture post-processor, the
      render pre-processor, the analyzer, a field trial and the data
      dumper;
    - ``echo_control_{jax,torch}``: an injected echo control that is the
      package's own AEC3;
    - ``builtin``: the port's built-in AEC3 on the same frames."""
    calls = {pkg: [] for pkg in PACKAGES}
    jobs = {"builtin": ("torch", lambda b: b, None, False)}
    for pkg in PACKAGES:
        jobs[f"injected_{pkg}"] = (pkg, _with_everything(pkg, calls[pkg]),
                                   tmp_path_factory.mktemp(pkg), True)
        jobs[f"echo_control_{pkg}"] = (
            pkg, lambda b, p=pkg: b.set_echo_control_factory(
                _echo_control_factory(p)), None, False)
    order = sorted(jobs, key=lambda k: not k.endswith("jax"))
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futures = {k: pool.submit(_aec3_run, jobs[k][0], jobs[k][1],
                                  jobs[k][2], taps=jobs[k][3])
                   for k in order}
        runs = {k: f.result() for k, f in futures.items()}
    runs["calls"] = calls
    return runs


def _rel_rms(got, want):
    err = np.sqrt(np.mean((got - want) ** 2))
    return err / max(np.sqrt(np.mean(want ** 2)), 1.0 / 32768.0)


def test_injected_neural_residual_echo_estimator_runs(api_runs):
    """The JAX test's shapes, batch first in the port; the estimator is
    called on every block (JAX traces each step once)."""
    got = api_runs["calls"]["torch"]
    assert len(got) == 2 + 3 + 2  # the blocks of frames 0, 1 and 2
    render, y, e, s2, y2, e2, dn = got[-1]
    assert render == (1, 1, 64)
    assert y == e == (1, 1, 64)
    assert s2 == y2 == e2 == (1, 1, 65)
    assert dn == (1,)
    jrender, jy, je, js2, jy2, je2, jdn = api_runs["calls"]["jax"][-1]
    assert (jrender, jy, js2) == ((1, 64), (1, 64), (1, 65))
    assert jdn == ()


@pytest.mark.parametrize("frame", range(AEC3_FRAMES))
def test_injected_aec3_outputs_match_jax(api_runs, frame):
    want, got = api_runs["injected_jax"], api_runs["injected_torch"]
    assert _rel_rms(got["out"][frame], want["out"][frame]) <= 1e-3
    np.testing.assert_allclose(got["render_out"][frame],
                               want["render_out"][frame], rtol=0, atol=1e-6)
    assert _rel_rms(got["linear"][frame], want["linear"][frame]) <= 1e-3
    g, w = got["stats"][frame], want["stats"][frame]
    assert g["delay_ms"] == w["delay_ms"]
    for k in ("residual_echo_likelihood", "echo_return_loss",
              "echo_return_loss_enhancement"):
        assert g[k] == pytest.approx(w[k], rel=1e-4, abs=1e-6), k


def test_injected_aec3_state_matches_jax(api_runs):
    """Every leaf after frame 1, the injected ones included, at
    ``STATE_RTOL``. The injected counters after the last frame."""
    got = dict(api_runs["injected_torch"]["state"])
    want = dict(api_runs["injected_jax"]["state"])
    want["aec3_block_ordinal"] = np.asarray(
        apm.block_ordinal(STATE_FRAME + 1), np.int32)
    assert_states_close(got, want, rtol=STATE_RTOL)
    last = api_runs["injected_torch"]["last_state"]
    for k in ("custom_capture_post['applied']", "custom_render_pre['applied']",
              "custom_analyzer['count']"):
        np.testing.assert_array_equal(last[k], [AEC3_FRAMES])
        np.testing.assert_array_equal(
            last[k], api_runs["injected_jax"]["last_state"][k])


def test_debug_taps_match_jax(api_runs):
    """One .npy a tap with the JAX package's names, a row a frame, the
    last block's values: flags exact, the rest within 1e-4 of each tap's
    scale."""
    want = api_runs["injected_jax"]["taps"]
    got = api_runs["injected_torch"]["taps"]
    assert sorted(got) == sorted(want) == sorted([
        "aec3_Y2", "aec3_E2", "aec3_S2_linear", "aec3_R2", "aec3_N2",
        "aec3_suppressor_gain", "aec3_output", "aec3_linear_aec_output",
        "aec3_usable_linear_estimate", "aec3_filter_delay"])
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape and g.shape[0] == AEC3_FRAMES, name
        if w.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            scale = max(float(np.abs(w).max()), 1e-6)
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * scale,
                                       err_msg=name)
    # The NREE's residual is the tap's R2.
    np.testing.assert_array_equal(got["aec3_R2"], 1e-3 * np.ones_like(
        got["aec3_R2"], dtype=np.float32))


def test_data_dumper_detach_rebuilds_without_taps(api_runs):
    ap = api_runs["injected_torch"]["ap"]
    ap.process_stream(_frames(1, seed=10)[0], RATE)
    assert not ap._geo.aec3.debug_taps
    assert "aec3_taps" not in ap._last_stats


@pytest.mark.parametrize("frame", range(AEC3_FRAMES))
def test_injected_echo_control_matches_jax(api_runs, frame):
    want = api_runs["echo_control_jax"]
    got = api_runs["echo_control_torch"]
    assert _rel_rms(got["out"][frame], want["out"][frame]) <= 1e-3
    assert _rel_rms(got["linear"][frame], want["linear"][frame]) <= 1e-3
    g, w = got["stats"][frame], want["stats"][frame]
    assert g["delay_ms"] == w["delay_ms"]
    assert g["echo_return_loss"] == pytest.approx(w["echo_return_loss"],
                                                  rel=1e-4)


def test_injected_echo_control_state_matches_jax(api_runs):
    """Every leaf after frame 1 at ``STATE_RTOL``, the echo control's
    ordinal exact."""
    got = dict(api_runs["echo_control_torch"]["state"])
    want = dict(api_runs["echo_control_jax"]["state"])
    # The port keeps the ordinal per stream.
    np.testing.assert_array_equal(got["echo_control['n0']"],
                                  [apm.block_ordinal(STATE_FRAME + 1)])
    assert_states_close(got, want, rtol=STATE_RTOL)


def test_injected_echo_control_equals_the_builtin_aec3(api_runs):
    """The port's own AEC3 behind the factory computes what the built-in
    one does, bit for bit, and its metrics reach get_statistics."""
    got, want = api_runs["echo_control_torch"], api_runs["builtin"]
    for f in range(AEC3_FRAMES):
        np.testing.assert_array_equal(got["out"][f], want["out"][f])
        np.testing.assert_array_equal(got["linear"][f], want["linear"][f])
        for k in ("delay_ms", "echo_return_loss",
                  "echo_return_loss_enhancement",
                  "residual_echo_likelihood"):
            assert got["stats"][f][k] == want["stats"][f][k], k
    geo = got["ap"]._geo
    assert geo.aec3 is None and geo.echo_control is not None
    assert geo.post_filter_enabled == want["ap"]._geo.post_filter_enabled


# ------------------------------------------------------------ state walkers


def _nested(batch):
    return {"b": (torch.arange(batch, dtype=torch.float32),
                  [torch.ones(batch, 2),
                   torch.zeros(batch, dtype=torch.int32)]),
            "a": {"z": torch.full((batch, 3), 2.0), "y": torch.ones(batch)}}


def test_walkers_follow_the_jax_pytree_order():
    """step_graph's leaves, state_to_numpy's paths and tree_to_state's
    fill follow jax.tree_util's order and key paths on dicts (sorted
    keys), tuples and lists."""
    tree = _nested(2)
    leaves = list(step_graph._tensor_leaves(tree))
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, tree))
    assert len(leaves) == len(want) == 5
    for g, w in zip(leaves, want):
        np.testing.assert_array_equal(g.numpy(), w)
    state = apm.init_state(apm.ApmGeometry.create(cfg_mod.Config(), RATE, 1),
                           2, "cpu")
    state.custom_analyzer = tree
    paths = apm.state_to_numpy(state)
    jpaths = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(np.asarray, tree))[0]
    for p, w in jpaths:
        np.testing.assert_array_equal(
            paths["custom_analyzer" + jax.tree_util.keystr(p)], w)
    src = jax.tree_util.tree_map(lambda a: np.asarray(a) + 1, tree)
    filled = apm.tree_to_state(tree, src)
    assert isinstance(filled["b"], tuple) and isinstance(filled["b"][1], list)
    np.testing.assert_array_equal(filled["a"]["z"].numpy(), 3.0)
    assert filled["b"][1][1].dtype == torch.int32
    with pytest.raises(ValueError):
        apm.tree_to_state(tree, {"a": src["a"]})


def test_untie_and_copy_into_walk_injected_states():
    shared = torch.zeros(2)
    owned = apm.init_state(apm.ApmGeometry.create(cfg_mod.Config(), RATE, 1),
                           2, "cpu")
    owned.custom_analyzer = {"x": shared, "y": (shared, torch.ones(2, 2))}
    step_graph.untie(owned)
    leaves = list(step_graph._tensor_leaves(owned.custom_analyzer))
    assert len({t.untyped_storage().data_ptr() for t in leaves}) == 3
    new = apm.init_state(apm.ApmGeometry.create(cfg_mod.Config(), RATE, 1),
                         2, "cpu")
    new.custom_analyzer = {"x": torch.full((2,), 5.0),
                           "y": (torch.full((2,), 6.0),
                                 torch.full((2, 2), 7.0))}
    before = [t.data_ptr() for t in step_graph._tensor_leaves(owned)]
    step_graph.copy_into(owned, new)
    assert [t.data_ptr() for t in step_graph._tensor_leaves(owned)] == before
    assert float(owned.custom_analyzer["y"][0][0]) == 6.0
    assert float(owned.custom_analyzer["x"][1]) == 5.0


def test_select_streams_walks_injected_states():
    state = {"a": torch.arange(4.0), "t": (torch.arange(8).reshape(4, 2),),
             "n": torch.tensor(3)}
    got = chip_smoke.select_streams(state, torch.tensor([1, 3]), "cpu")
    np.testing.assert_array_equal(got["a"].numpy(), [1.0, 3.0])
    np.testing.assert_array_equal(got["t"][0].numpy(), [[2, 3], [6, 7]])
    assert int(got["n"]) == 3


def test_builder_imports_and_runs_without_jax():
    """With jax unimportable, the builder, the field trials and an injected
    frame through the API run on the CPU, and nothing of the JAX package
    is imported."""
    import subprocess
    import sys

    code = r"""
import sys
sys.modules["jax"] = None
import numpy as np, torch
import webrtc_audio_processing_tpu_torch as port
from webrtc_audio_processing_tpu_torch import builder, config as c
half = builder.CustomProcessing(
    init=lambda rate, ch, b, dev: {"n": torch.zeros(b, device=dev)},
    process=lambda st, x: ({"n": st["n"] + 1}, 0.5 * x))
ap = (port.AudioProcessingBuilder(c.Config().replace(
        echo_canceller=c.EchoCanceller(enabled=True)))
      .set_field_trials(port.FieldTrials(
          "WebRTC-Aec3OnsetDetectionKillSwitch/Enabled/"))
      .set_capture_post_processing(half)
      .set_echo_control_factory(builder.aec3_echo_control_factory())
      .build(device="cpu"))
err, y = ap.process_stream(np.full((160, 1), 0.1, np.float32), 16000)
assert err == 0 and y.shape == (160, 1)
assert ap._aec3_config.erle.onset_detection is False
bad = [m for m in sys.modules
       if m == "jax" or m.startswith(("jax.", "jaxlib",
                                      "webrtc_audio_processing_tpu."))
       or m == "webrtc_audio_processing_tpu"]
assert not [m for m in bad if sys.modules[m] is not None], bad
print("ok")
"""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
