"""Training: optimizer state, steps, loop, metrics, logging, checkpoints."""
