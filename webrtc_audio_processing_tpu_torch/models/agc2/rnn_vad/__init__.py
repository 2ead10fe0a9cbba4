"""RNN voice activity detector: pitch, features and the GRU network."""
