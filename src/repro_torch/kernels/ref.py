"""Plain PyTorch versions of the port's kernels (the allclose ground truth).

Ports of :func:`repro.kernels.ref.poibin_dft_ref`,
:func:`repro.kernels.ref.fedavg_agg_ref`,
:func:`repro.kernels.ref.flash_attention_ref` and
:func:`repro.kernels.ref.fused_ce_ref`. The kernel wrappers run these for
a tensor on the CPU; ``chip_smoke.py`` holds each CUDA kernel against them
on the card; the model kernels' backward passes are their VJPs.
"""
from __future__ import annotations

import torch

from repro_torch.core.poibin import poibin_pmf, poibin_pmf_loo

__all__ = ["poibin_dft_ref", "fedavg_agg_ref", "flash_attention_ref",
           "fused_ce_ref"]


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


def fedavg_agg_ref(global_flat: torch.Tensor, client_flat: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Masked mean over the client axis with the k = 0 fallback.

    global_flat: ``(P,)`` or ``(B, P)``; client_flat: ``(N, P)`` or
    ``(B, N, P)``; mask: ``(N,)`` or ``(B, N)``, bool 0/1 participation or
    float participation·weight products (the weighted FedAvg path — the
    math is the same Σmθ/Σm). fp32 accumulation (a product over the client
    axis, as the reference's einsum); output in ``global_flat.dtype``; an
    all-zero mask returns the previous global cast through fp32.
    """
    m = mask.to(torch.float32)
    total = torch.sum(m, dim=-1, keepdim=True)
    avg = torch.matmul(m.unsqueeze(-2),
                       client_flat.to(torch.float32)).squeeze(-2) \
        / torch.clamp(total, min=1e-9)
    return torch.where(total > 0, avg,
                       global_flat.to(torch.float32)).to(global_flat.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0,
                        scale: float | None = None) -> torch.Tensor:
    """q: ``(B, S, H, D)``; k, v: ``(B, S, KV, D)``; GQA broadcast (query
    head h reads kv head ``h // (H / KV)``); fp32 softmax.

    ``window > 0`` limits attention to the last ``window`` positions
    (self included): j in (i - window, i]. Scores are the input dtype's
    product cast to fp32; the probabilities are cast back to v's dtype
    before the value product, as in the reference.
    """
    b, s, h, d = q.shape
    kvh = k.shape[2]
    groups = h // kvh
    scale = d ** -0.5 if scale is None else scale
    qg = q.reshape(b, s, kvh, groups, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float() * scale
    i = torch.arange(s, device=q.device)[:, None]
    j = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (i >= j)
    if window > 0:
        mask = mask & ((i - j) < window)
    scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)
    return out.reshape(b, s, h, d)


def fused_ce_ref(hidden: torch.Tensor, w_vocab: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
    """Per-token NLL via dense fp32 logits (the memory hog the kernel
    avoids). hidden ``(..., T, d)``, w_vocab ``(..., d, V)``, labels
    ``(..., T)`` integers → ``(..., T)`` float32."""
    logits = hidden.float() @ w_vocab.float()
    lse = torch.logsumexp(logits, dim=-1)
    lab = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return lse - lab
