"""Host runtime: the native streaming plane, the batching engine, and the
APM step it drives."""

from webrtc_audio_processing_tpu_torch.runtime.streaming import (  # noqa: F401
    BatchEngine,
    StreamingPlane,
)
from webrtc_audio_processing_tpu_torch.runtime.step import (  # noqa: F401
    apm_step_fn,
)
