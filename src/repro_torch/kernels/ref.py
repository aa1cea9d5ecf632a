"""Plain PyTorch versions of the port's kernels (the allclose ground truth).

Port of :func:`repro.kernels.ref.poibin_dft_ref`. The kernel wrappers run
these for a tensor on the CPU; ``chip_smoke.py`` holds each CUDA kernel
against them on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.poibin import poibin_pmf, poibin_pmf_loo

__all__ = ["poibin_dft_ref"]


def poibin_dft_ref(p_mat: torch.Tensor, with_loo: bool = True):
    """Batched Poisson-Binomial DFT pmf + leave-one-out deconvolution.

    p_mat: (B, N) probabilities in [0, 1]. Returns pmf (B, N+1) and — with
    ``with_loo`` — loo (B, N, N+1) where ``loo[b, i]`` is the pmf of
    scenario b's nodes excluding node i (support 0..N-1, last entry zero).

    Eq. (9) DFT with clip + renormalize (complex64 for a float32 input,
    complex128 otherwise), then forward deconvolution where p ≤ 1/2 and
    backward where p > 1/2 — all in the input dtype.
    """
    pmf = poibin_pmf(p_mat)
    if not with_loo:
        return pmf
    return pmf, poibin_pmf_loo(pmf[:, None, :], p_mat)
