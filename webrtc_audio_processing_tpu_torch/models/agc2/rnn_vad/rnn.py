"""RNN-VAD network: FC(42->24, tansig) + GRU(24) + FC(24->1, sigmoid).

Port of ``webrtc_audio_processing_tpu/models/agc2/rnn_vad/rnn.py``
(reference: agc2/rnn_vad/rnn.cc, rnn_fc.cc, rnn_gru.cc, with the quantized
int8 rnnoise weights scaled by 1/256 and the table-based activations of
rnn_activations.h). The weights are read from ``rnnoise_weights.npz``
beside this module (a byte-identical copy of the JAX twin's file) and become
registered buffers.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
from torch import nn

WEIGHTS_SCALE = 1.0 / 256.0  # rnn_vad_weights.h:10
INPUT_SIZE = 42
HIDDEN_SIZE = 24

# The package's own copy of the weight file.
WEIGHTS_PATH = Path(__file__).resolve().parent / "rnnoise_weights.npz"


def read_weight_arrays(path: Path | str = WEIGHTS_PATH) -> dict:
    """The raw int8 arrays of the weight file, as numpy."""
    with np.load(path) as raw:
        return {k: raw[k] for k in raw.files}


def preprocess_weights(raw: dict) -> dict:
    """int8 arrays -> float32 layer weights (same layout as the JAX twin's
    ``_load_weights``)."""
    s = WEIGHTS_SCALE

    def fc(w, in_size, out_size):
        # rnn_fc.cc PreprocessWeights: stored input-major [i*out + o].
        return (w.astype(np.float32) * s).reshape(in_size, out_size)

    def gru(w, n, out_size):
        # rnn_gru.cc PreprocessGruTensor: [i*3*out + g*out + o] -> (3, n, out).
        return (w.astype(np.float32) * s).reshape(n, 3, out_size).transpose(
            1, 0, 2)

    return {
        "fc1_w": fc(raw["input_weights"], INPUT_SIZE, HIDDEN_SIZE),
        "fc1_b": raw["input_bias"].astype(np.float32) * s,
        "gru_w": gru(raw["gru_weights"], HIDDEN_SIZE, HIDDEN_SIZE),
        "gru_r": gru(raw["gru_recurrent_weights"], HIDDEN_SIZE, HIDDEN_SIZE),
        "gru_b": (raw["gru_bias"].astype(np.float32) * s).reshape(
            3, HIDDEN_SIZE),
        "fc2_w": raw["output_weights"].astype(np.float32) * s,
        "fc2_b": raw["output_bias"].astype(np.float32) * s,
    }


def tansig_approx(x: torch.Tensor) -> torch.Tensor:
    """TansigApproximated (rnn_activations.h:36-96): the table entry
    round(tanh(0.04 i), 6) computed arithmetically, as the JAX twin does."""
    sign = torch.where(x < 0.0, -1.0, 1.0)
    ax = torch.abs(x)
    i = torch.floor(0.5 + 25.0 * torch.clamp(ax, max=8.0)).to(torch.int32)
    i = torch.clamp(i, 0, 200)
    fi = i.to(x.dtype)
    y = torch.round(torch.tanh(0.04 * fi) * 1e6) * 1e-6
    xx = ax - 0.04 * fi
    y = y + xx * (1.0 - y * y) * (1.0 - y * xx)
    out = sign * y
    out = torch.where(x >= 8.0, 1.0, out)
    out = torch.where(x <= -8.0, -1.0, out)
    return torch.where(torch.isnan(x), 1.0, out)


def sigmoid_approx(x: torch.Tensor) -> torch.Tensor:
    """SigmoidApproximated (rnn_activations.h:98-100)."""
    return 0.5 + 0.5 * tansig_approx(0.5 * x)


@dataclass
class RnnState:
    gru: torch.Tensor  # (B, 24)


def init_state(batch: int, device) -> RnnState:
    return RnnState(gru=torch.zeros((batch, HIDDEN_SIZE), dtype=torch.float32,
                                    device=device))


class RnnVad(nn.Module):
    """RnnVad::ComputeVadProbability (rnn.cc:70-84)."""

    def __init__(self, raw_weights: dict | None = None):
        super().__init__()
        if raw_weights is None:
            raw_weights = read_weight_arrays()
        for name, w in preprocess_weights(raw_weights).items():
            self.register_buffer(name, torch.from_numpy(np.ascontiguousarray(w)))

    def forward(self, state: RnnState, features: torch.Tensor,
                is_silence: torch.Tensor):
        """features (B, 42), is_silence (B,) -> (state, probability (B,)).
        On silence the GRU state resets and the probability is 0."""
        h1 = tansig_approx(features @ self.fc1_w + self.fc1_b)
        s = state.gru
        update = sigmoid_approx(h1 @ self.gru_w[0] + s @ self.gru_r[0]
                                + self.gru_b[0])
        reset = sigmoid_approx(h1 @ self.gru_w[1] + s @ self.gru_r[1]
                               + self.gru_b[1])
        cand = (h1 @ self.gru_w[2] + (s * reset) @ self.gru_r[2]
                + self.gru_b[2])
        new_s = update * s + (1.0 - update) * torch.clamp(cand, min=0.0)

        prob = sigmoid_approx(new_s @ self.fc2_w + self.fc2_b[0])
        new_s = torch.where(is_silence[:, None], torch.zeros_like(new_s),
                            new_s)
        prob = torch.where(is_silence, 0.0, prob)
        return RnnState(gru=new_s), prob
