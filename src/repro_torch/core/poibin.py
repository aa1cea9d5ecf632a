"""Poisson-Binomial distribution of the number of participating nodes.

Port of :mod:`repro.core.poibin`. Paper eq. (9): the DFT closed form of the
pmf of ``m = Σ_i X_i`` with independent ``X_i ~ Bernoulli(p_i)``, and
eq. (8): the expected task duration ``E[D] = Σ_k d(k) P[m=k]``.

Every function works on the last axis and broadcasts over any leading
batch axes, in the dtype and on the device of its input (the game layer
passes ``torch.float64``). The batched entry points
(:func:`poibin_pmf_batched`, :func:`poibin_pmf_loo_all`) dispatch through
:mod:`repro_torch.kernels.ops`: ``backend="kernel"`` runs the fused fp32
``poibin_dft`` program, the default ``"ref"`` the f64 recursion below.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = [
    "poibin_pmf",
    "poibin_pmf_recursive",
    "poibin_convolve",
    "poibin_pmf_loo",
    "poibin_pmf_batched",
    "poibin_pmf_loo_all",
    "poibin_mean",
    "poibin_cdf",
    "expected_duration",
    "symmetric_pmf",
]


def _unit_circle(angle: torch.Tensor, cdtype: torch.dtype) -> torch.Tensor:
    """``exp(i·angle)`` for a real f64 angle, cast to ``cdtype``."""
    return torch.complex(torch.cos(angle), torch.sin(angle)).to(cdtype)


def poibin_pmf(p: torch.Tensor) -> torch.Tensor:
    """Pmf of the Poisson-Binomial distribution via the DFT closed form.

    Implements paper eq. (9)::

        P[m] = (1/(N+1)) Σ_n exp(-j2πnm/(N+1)) Π_k [p_k (exp(j2πn/(N+1)) - 1) + 1]

    Args:
        p: ``(..., N)`` participation probabilities in [0, 1].

    Returns:
        ``(..., N+1)`` real pmf over m = 0..N (complex128 arithmetic for a
        float64 input, complex64 for float32).
    """
    n_nodes = p.shape[-1]
    size = n_nodes + 1
    cdtype = torch.complex64 if p.dtype == torch.float32 else torch.complex128
    idx = torch.arange(size, dtype=torch.float64, device=p.device)
    omega = _unit_circle(2.0 * math.pi * idx / size, cdtype)      # (S,)
    terms = p[..., None, :] * (omega[:, None] - 1.0) + 1.0        # (..., S, N)
    chi = torch.prod(terms, dim=-1)                               # (..., S)
    dft = _unit_circle(-2.0 * math.pi * torch.outer(idx, idx) / size, cdtype)
    pmf = (chi @ dft.T).real / size
    pmf = torch.clamp(pmf, 0.0, 1.0)
    return pmf / torch.sum(pmf, dim=-1, keepdim=True)


def poibin_pmf_recursive(p: torch.Tensor) -> torch.Tensor:
    """Pmf via the stable O(N²) convolution recursion (oracle for tests).

    ``f_{k+1} = conv(f_k, [1-p_k, p_k])`` — exact up to float error, no DFT.
    """
    n_nodes = p.shape[-1]
    pmf = torch.zeros(p.shape[:-1] + (n_nodes + 1,), dtype=p.dtype,
                      device=p.device)
    pmf[..., 0] = 1.0
    for k in range(n_nodes):
        pmf = poibin_convolve(pmf, p[..., k])
    return pmf


def poibin_convolve(pmf: torch.Tensor, p_k: torch.Tensor) -> torch.Tensor:
    """Fold one Bernoulli(``p_k``) factor into a Poisson-Binomial pmf.

    ``pmf`` is ``(..., S)`` with a zero top entry (the support grows by
    one); ``p_k`` broadcasts against ``pmf.shape[:-1]``. The single step of
    :func:`poibin_pmf_recursive`.
    """
    p_k = torch.as_tensor(p_k, dtype=pmf.dtype, device=pmf.device)[..., None]
    shifted = F.pad(pmf[..., :-1], (1, 0))
    return pmf * (1.0 - p_k) + shifted * p_k


def poibin_pmf_loo(pmf: torch.Tensor, p_i: torch.Tensor) -> torch.Tensor:
    """Leave-one-out deconvolution: divide node i's Bernoulli factor back out.

    Given the ``(..., N+1)`` pmf of all N nodes and node i's probability
    ``p_i`` (broadcast against ``pmf.shape[:-1]``), returns the
    ``(..., N+1)`` pmf of the other N-1 nodes (last entry zero); it
    inverts :func:`poibin_convolve`.

    Each lane runs the recursion whose per-step error amplification is ≤ 1:

    * forward  ``g[k] = (f[k] - p_i·g[k-1]) / (1-p_i)`` when ``p_i ≤ 1/2``,
    * backward ``g[k] = (f[k+1] - (1-p_i)·g[k+1]) / p_i`` when ``p_i > 1/2``.

    The reference computes both and selects; here the two are one loop
    over lanes that read their input forwards or reversed, so a lane only
    ever divides by its own ``max(p_i, 1-p_i) ≥ 1/2`` (the p ∈ {0, 1}
    corners degenerate to a copy/shift) and does the selected branch's
    exact arithmetic.
    """
    n_nodes = pmf.shape[-1] - 1
    p_i = torch.as_tensor(p_i, dtype=pmf.dtype, device=pmf.device)
    batch = torch.broadcast_shapes(pmf.shape[:-1], p_i.shape)
    pmf = pmf.expand(batch + pmf.shape[-1:])
    p_i = p_i.expand(batch)
    q_i = 1.0 - p_i
    use_fwd = p_i <= 0.5
    x = torch.where(use_fwd[..., None], pmf[..., :-1],
                    pmf[..., 1:].flip(-1))                     # (..., N)
    a = torch.where(use_fwd, p_i, q_i)
    d = torch.where(use_fwd, q_i, p_i)
    out = torch.empty((n_nodes,) + p_i.shape, dtype=pmf.dtype,
                      device=pmf.device)
    g = torch.zeros_like(p_i)
    for k in range(n_nodes):
        g = torch.div(torch.addcmul(x[..., k], a, g, value=-1.0), d,
                      out=out[k])
    g = torch.movedim(out, 0, -1)
    g = torch.where(use_fwd[..., None], g, g.flip(-1))
    return F.pad(g, (0, 1))


def poibin_pmf_batched(p: torch.Tensor, *, backend: str | None = None
                       ) -> torch.Tensor:
    """Pmfs of a whole ``(B, N)`` probability matrix, ``(B, N+1)``.

    ``backend="kernel"`` runs the batched DFT kernel
    (:mod:`repro_torch.kernels.poibin_dft`, fp32); the default ``"ref"``
    is :func:`poibin_pmf` over the batch in the input dtype.
    """
    from repro_torch.kernels import ops  # lazy: keep core light

    if ops.resolve_backend(backend, default="ref",
                           site="poibin.pmf_batched") == "kernel":
        return ops.poibin_pmf(p, backend="kernel")
    return poibin_pmf(p)


def poibin_pmf_loo_all(p: torch.Tensor, *, backend: str | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """All leave-one-out pmfs of a ``(B, N)`` batch in one pass.

    Returns ``(pmf (B, N+1), loo (B, N, N+1))`` where ``loo[b, i]`` is the
    pmf of scenario b's nodes excluding node i. ``backend="kernel"`` fuses
    DFT pmf + N deconvolutions per scenario into one kernel; the default
    ``"ref"`` builds the pmf with the convolution recursion and
    deconvolves it — the op sequence of the heterogeneous-game certifier.
    """
    from repro_torch.kernels import ops  # lazy: keep core light

    if ops.resolve_backend(backend, default="ref",
                           site="poibin.pmf_loo_all") == "kernel":
        return ops.poibin(p, backend="kernel")
    pmf = poibin_pmf_recursive(p)
    loo = poibin_pmf_loo(pmf[..., None, :], p)
    return pmf, loo


def poibin_mean(p: torch.Tensor) -> torch.Tensor:
    """E[m] = Σ_i p_i."""
    return torch.sum(p, dim=-1)


def poibin_cdf(p: torch.Tensor) -> torch.Tensor:
    """Cdf over m = 0..N."""
    return torch.cumsum(poibin_pmf(p), dim=-1)


def symmetric_pmf(p_scalar, n_nodes: int) -> torch.Tensor:
    """Pmf when all nodes share probability ``p`` (Binomial(N, p)) via eq. (9).

    A Python float is taken as ``torch.float64``.
    """
    p = torch.as_tensor(p_scalar, dtype=torch.float64
                        if not isinstance(p_scalar, torch.Tensor)
                        else p_scalar.dtype)
    return poibin_pmf(p[..., None].expand(p.shape + (n_nodes,)))


def expected_duration(p: torch.Tensor, duration_of_k: torch.Tensor
                      ) -> torch.Tensor:
    """Paper eq. (8): ``E[D] = Σ_{i=0}^{N} d(i) P[m=i]``.

    Args:
        p: ``(..., N)`` participation probabilities.
        duration_of_k: ``(N+1,)`` rounds-to-converge when exactly k nodes
            participate each round (see :mod:`repro_torch.core.duration`).
    """
    return torch.sum(poibin_pmf(p) * duration_of_k, dim=-1)
