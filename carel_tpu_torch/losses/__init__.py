"""Losses: classifier, VAE and disentanglement-regularizer terms."""
