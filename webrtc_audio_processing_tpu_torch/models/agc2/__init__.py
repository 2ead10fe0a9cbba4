"""AGC2: RNN-VAD, adaptive digital gain and limiter."""
