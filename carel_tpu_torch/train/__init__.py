"""Training: optimizer state, steps, loop, metrics, logging, checkpoints,
and the plain pair classifier's trainer."""
