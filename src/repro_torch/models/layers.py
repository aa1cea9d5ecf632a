"""Neural-net layers of the dense transformer family, in PyTorch.

Port of the dense subset of :mod:`repro.models.layers`: initialisers,
rmsnorm / layernorm, rotary embeddings, GQA attention on the full sequence
(training and prefill) and the gated / plain MLP. Parameters are flat dicts
of tensors; the reference's logical sharding axes have no counterpart on
one card and are dropped, so every ``init_*`` returns the parameters only.
Randomness comes from an explicit ``torch.Generator``; the numbers differ
from the reference's (another generator), so parity tests hand the
reference's parameters across (:func:`repro_torch.convert.
model_params_from_numpy`).

Under :func:`repro_torch.models.runtime.kernel_scope` the attention of
:func:`attention_apply` goes through :func:`repro_torch.kernels.ops.
attention` (the flash-attention kernel, or its oracle). Not ported: decode
caches (ROADMAP.md queue 1 item 10, serving), MLA and MoE (queue 1 item
7.3); they raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import runtime

__all__ = ["DECODE_TODO", "MLA_MOE_TODO", "dense_init", "init_norm",
           "apply_norm", "rope_frequencies", "apply_rope", "init_attention",
           "sdpa", "attention_apply", "init_mlp", "mlp_apply"]

DECODE_TODO = ("decode caches and serving are not ported yet (ROADMAP.md, "
               "queue 1 item 10)")
MLA_MOE_TODO = ("MLA attention and MoE layers are not ported yet "
                "(ROADMAP.md, queue 1 item 7.3)")


def _dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name (``"bfloat16"``, ...)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt


def dense_init(gen: torch.Generator, shape: tuple, dtype: torch.dtype,
               in_axis_sizes: int | None = None,
               scale: float | None = None) -> torch.Tensor:
    """Truncated-normal (±2σ) fan-in init, drawn in float32 from ``gen`` on
    its device, cast to ``dtype``."""
    fan_in = shape[0] if in_axis_sizes is None else in_axis_sizes
    std = scale if scale is not None else (1.0 / max(fan_in, 1)) ** 0.5
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * std).to(dtype)


# --------------------------------------------------------------------------
# normalization
# --------------------------------------------------------------------------


def init_norm(cfg: ModelConfig, dtype: torch.dtype,
              device: torch.device) -> dict:
    params = {"scale": torch.ones(cfg.d_model, dtype=dtype, device=device)}
    if cfg.norm != "rmsnorm":
        params["bias"] = torch.zeros(cfg.d_model, dtype=dtype, device=device)
    return params


def apply_norm(cfg: ModelConfig, params: dict, x: torch.Tensor
               ) -> torch.Tensor:
    """rmsnorm (eps 1e-6) or layernorm (eps 1e-5), computed in float32,
    returned in x's dtype."""
    xf = x.float()
    if cfg.norm == "rmsnorm":
        var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + 1e-6) * params["scale"].float()
    else:
        mean = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, correction=0)
        y = ((xf - mean) * torch.rsqrt(var + 1e-5) * params["scale"].float()
             + params["bias"].float())
    return y.to(x.dtype)


# --------------------------------------------------------------------------
# rotary embeddings
# --------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float,
                     device: torch.device | None = None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: ``(..., S, H, D)`` rotated by halves (the first D/2 against the
    last D/2, not interleaved); positions: ``(..., S)``."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)  # (D/2,)
    angles = positions[..., None].float() * freqs          # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                  # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# GQA attention
# --------------------------------------------------------------------------


def init_attention(cfg: ModelConfig, gen: torch.Generator) -> dict:
    dtype = _dtype(cfg.param_dtype)
    d, h, kv, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                    cfg.resolved_head_dim)
    return {"wq": dense_init(gen, (d, h, hd), dtype),
            "wk": dense_init(gen, (d, kv, hd), dtype),
            "wv": dense_init(gen, (d, kv, hd), dtype),
            "wo": dense_init(gen, (h, hd, d), dtype, in_axis_sizes=h * hd)}


def _attn_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
               window: int) -> torch.Tensor:
    """``(..., Q, K)`` boolean mask: causal, optionally sliding-window."""
    mask = q_pos[..., :, None] >= k_pos[..., None, :]
    if window > 0:
        mask = mask & ((q_pos[..., :, None] - k_pos[..., None, :]) < window)
    return mask


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """Plain scaled-dot-product attention with the GQA head-group broadcast.

    q: ``(B, S, H, D)``; k/v: ``(B, T, KV, D)``; mask ``(B, 1, S, T)`` or
    ``(S, T)``. The scores are the compute dtype's product cast to fp32;
    fp32 softmax; the probabilities go back to the compute dtype.
    """
    b, s, h, d = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float() * d ** -0.5
    if mask.dim() == 2:
        mask_b = mask[None, None, None, :, :]
    else:
        mask_b = mask[:, :, None, :, :]  # (B,1,1,S,T) broadcast over k, g
    scores = torch.where(mask_b, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(compute_dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, d)


def attention_apply(cfg: ModelConfig, params: dict, x: torch.Tensor,
                    positions: torch.Tensor, window: int = 0, cache=None,
                    ring: bool = False):
    """GQA attention over the full sequence. Returns ``(y, None)``; a
    ``cache`` (single-token decode) raises ``NotImplementedError``."""
    if cache is not None or ring:
        raise NotImplementedError(DECODE_TODO)
    cdt = _dtype(cfg.compute_dtype)
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(cdt))
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"].to(cdt))
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"].to(cdt))
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    kb = runtime.kernel_backend()
    if kb is not None:
        out = ops.attention(q, k, v, causal=True, window=window, backend=kb)
    else:
        pos_row = positions[0] if positions.dim() > 1 else positions
        out = sdpa(q, k, v, _attn_mask(pos_row, pos_row, window), cdt)
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(cdt))
    return y, None


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------


def init_mlp(cfg: ModelConfig, gen: torch.Generator,
             d_ff: int | None = None) -> dict:
    dtype = _dtype(cfg.param_dtype)
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    params = {}
    if cfg.act in ("swiglu", "geglu"):
        params["w_gate"] = dense_init(gen, (d, ff), dtype)
    params["w_up"] = dense_init(gen, (d, ff), dtype)
    params["w_down"] = dense_init(gen, (ff, d), dtype)
    return params


def mlp_apply(cfg: ModelConfig, params: dict, x: torch.Tensor
              ) -> torch.Tensor:
    cdt = _dtype(cfg.compute_dtype)
    up = torch.einsum("bsd,df->bsf", x, params["w_up"].to(cdt))
    if cfg.act == "swiglu":
        gate = torch.einsum("bsd,df->bsf", x, params["w_gate"].to(cdt))
        hidden = F.silu(gate) * up
    elif cfg.act == "geglu":
        gate = torch.einsum("bsd,df->bsf", x, params["w_gate"].to(cdt))
        hidden = F.gelu(gate, approximate="tanh") * up
    else:
        hidden = F.gelu(up, approximate="tanh")
    return torch.einsum("bsf,fd->bsd", hidden, params["w_down"].to(cdt))
