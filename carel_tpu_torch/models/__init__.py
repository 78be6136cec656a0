"""Models: encoder, VAE heads and attention adapters, discriminators, the
DrlModel and the plain pair classifier."""
