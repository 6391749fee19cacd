"""Atomic, keep-k checkpoints of the model and the optimizer state."""
