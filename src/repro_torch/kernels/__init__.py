"""Hand-written CUDA kernels of the port, their plain PyTorch versions
(:mod:`~repro_torch.kernels.ref`) and the backend dispatch layer
(:mod:`~repro_torch.kernels.ops`)."""
