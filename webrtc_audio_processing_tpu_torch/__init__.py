"""PyTorch/CUDA port of the WebRTC AudioProcessing module.

The JAX package ``webrtc_audio_processing_tpu`` beside this one is the
reference; each module here names its JAX twin at the same path. The port
imports torch and numpy, never jax. Streams are batched on a leading axis
``(B, ...)`` in place of ``jax.vmap``; per-stream state is a dataclass of
tensors with that batch axis first.

Float32 throughout: importing the package turns TF32 off for matrix
products and cuDNN convolutions, which would otherwise cost the band
matrices, the DCT and the pitch correlations about four decimal digits.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = [
    "AudioProcessing",
    "AudioProcessingBuilder",
    "BuiltinAudioProcessingBuilder",
    "FieldTrials",
    "RuntimeSetting",
]


def __getattr__(name):
    # Lazy exports, as the JAX package's __init__.py:37-56: importing the
    # package stays light for config-only use.
    if name in ("AudioProcessing", "RuntimeSetting"):
        from webrtc_audio_processing_tpu_torch import api

        return getattr(api, name)
    if name in ("AudioProcessingBuilder", "BuiltinAudioProcessingBuilder"):
        from webrtc_audio_processing_tpu_torch import builder

        return getattr(builder, name)
    if name == "FieldTrials":
        from webrtc_audio_processing_tpu_torch import field_trials

        return field_trials.FieldTrials
    raise AttributeError(name)
