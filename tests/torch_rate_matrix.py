"""The APM's rate and channel matrix for the desktop pipeline (HPF, AEC3,
NS, AGC2 with adaptive digital and the RNN-VAD, echo detector), shared by
the JAX parity test (``tests/test_torch_rate_matrix.py``, marked slow) and
the card test (``tests/test_torch_cuda.py``). It imports no JAX, so the
card's tests can use it.

Cases: 8, 16, 32 and 48 kHz at the API x 1 or 2 capture channels x 1 or 2
render channels under the default internal-rate cap (32 kHz), and the four
48 kHz cases with the cap at 48 kHz (the cap changes nothing below
48 kHz). Multichannel capture and render are on wherever there are two
channels; no stereo render content is set, so a stereo render runs mono
AEC3 on its downmix."""

import numpy as np

import chip_smoke

CASES = {}
for _rate in (8000, 16000, 32000, 48000):
    for _cap in (1, 2):
        for _ren in (1, 2):
            CASES[f"{_rate // 1000}k_c{_cap}_r{_ren}"] = (_rate, _cap, _ren,
                                                           32000)
            if _rate == 48000:
                CASES[f"48k_c{_cap}_r{_ren}_cap48"] = (_rate, _cap, _ren,
                                                       48000)


def config(cfg_mod, case):
    """The case's ``Config`` in package ``cfg_mod``'s classes."""
    _, cap, ren, internal = CASES[case]
    return cfg_mod.Config().replace(
        pipeline=cfg_mod.Pipeline(multi_channel_capture=cap > 1,
                                  multi_channel_render=ren > 1,
                                  maximum_internal_processing_rate=internal),
        high_pass_filter=cfg_mod.HighPassFilter(enabled=True),
        echo_canceller=cfg_mod.EchoCanceller(enabled=True),
        noise_suppression=cfg_mod.NoiseSuppression(enabled=True),
        gain_controller2=cfg_mod.GainController2(
            enabled=True,
            adaptive_digital=cfg_mod.AdaptiveDigital(enabled=True)),
    )


def geometry(apm_mod, cfg_mod, case):
    rate, cap, ren, _ = CASES[case]
    return apm_mod.ApmGeometry.create(config(cfg_mod, case), rate, cap,
                                      render_input_rate=rate,
                                      num_render_channels=ren)


def scene(case, n_frames, batch, seed):
    """``chip_smoke.echo_scene`` cut to the case's channels, as frames:
    (render, capture), each (n_frames, B, rate / 100, channels). A stereo
    render's second channel carries extra noise in odd streams, so their
    frames hold stereo content (AEC3's downmix takes the channel mean)
    while even streams' do not (it takes channel 0)."""
    rate, cap, ren, _ = CASES[case]
    render, capture = chip_smoke.echo_scene(n_frames, seed, range(batch),
                                            rate, max(cap, ren))
    render, capture = render[..., :ren].copy(), capture[..., :cap].copy()
    if ren > 1:
        rng = np.random.default_rng(seed)
        render[1::2, :, 1] += 0.02 * rng.standard_normal(
            render[1::2, :, 1].shape).astype(np.float32)
    frame = rate // 100

    def frames(x):
        return np.ascontiguousarray(x.reshape(
            batch, n_frames, frame, x.shape[-1]).transpose(1, 0, 2, 3))

    return frames(render), frames(capture)
