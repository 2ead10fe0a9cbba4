"""The legacy GMM VAD and the analytics (pitch-based) VAD."""
