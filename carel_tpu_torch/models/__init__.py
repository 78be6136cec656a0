"""Models: encoder, VAE heads, discriminators and the DrlModel."""
