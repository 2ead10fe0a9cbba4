"""The APM step as ``BatchEngine`` drives it.

``apm_step_fn(geo, batch)`` builds the state of ``batch`` streams and the
engine's ``step_fn(state, capture, render) -> (state, out)``: on the card
the one-frame step captured as one graph per frame of the cadence's period
(``step_graph.FrameGraphs``: 2, or 6 with the hybrid AGC1), on the CPU the eager ``Apm.forward``. As ``apm``'s
entry points, it puts the state on the card unless ``device`` says
otherwise, and raises when there is no card.
"""

from __future__ import annotations

from webrtc_audio_processing_tpu_torch import apm, step_graph


def apm_step_fn(geo: apm.ApmGeometry, batch: int, device=None):
    """Returns (step_fn, state, graphs): ``graphs`` the ``FrameGraphs``
    the step replays, or None when it runs eagerly (on the CPU)."""
    state = apm.init_state(geo, batch, device)
    if state.frame_parity.device.type == "cuda":
        graphs = step_graph.FrameGraphs(geo, state)
        graphs.capture_graphs()

        def step_fn(state, capture, render):
            out, _, _ = graphs.replay(capture, render)
            return state, out

        return step_fn, graphs.state, graphs
    module = apm.module_for(geo, state.frame_parity.device)

    def step_fn(state, capture, render):
        state, out, _, _ = module(state, capture, render)
        return state, out

    return step_fn, state, None
