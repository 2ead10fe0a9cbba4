"""Host-side utilities: WAV/PCM I/O and the metric reporters."""
