"""Game-theoretic participation control (the paper), ported to PyTorch.

The game math runs in ``torch.float64``, passed explicitly: the reference
turns on JAX's x64 mode for the same headroom (NE root finding, the
Poisson-Binomial DFT at N = 50).
"""
