"""The plain reference: the models of the benchmark's configurations, their
losses and optimizers in plain PyTorch, fp32 with TF32 off. It imports
nothing of the program and takes nothing the program made: the benchmark
hands it the seed's weights and inputs, and it draws its own noise."""
