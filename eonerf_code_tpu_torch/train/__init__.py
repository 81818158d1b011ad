"""The single-AOI trainer and its checkpoints."""
