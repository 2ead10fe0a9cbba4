"""AEC3, the echo canceller (port of the JAX package's models/aec3)."""
