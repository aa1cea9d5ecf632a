"""Decoder-only transformer LM, dense family, in PyTorch.

Port of the dense family of :mod:`repro.models.transformer`. Parameters are
one flat dict with dotted names mirroring the reference's nested tree::

    embed                       (V, d)
    layers.body.<leaf>          (L, ...)   e.g. layers.body.attn.wq (L, d, H, hd)
    ln_f.scale [, ln_f.bias]    (d,)
    lm_head                     (d, V)     unless tie_embeddings

The layer leaves keep the reference's stacked leading ``layers`` axis; its
``lax.scan`` over layers becomes a Python loop over views of the stacked
leaves. Under :func:`repro_torch.models.runtime.kernel_scope` the loss
takes the fused cross-entropy dispatch (:func:`repro_torch.kernels.ops.
cross_entropy`) on the final hidden states, so the ``(B, S, V)`` logits
are never stored. Not ported: MoE and VLM (ROADMAP.md queue 1 item 7.3),
gradient checkpointing (``remat``, item 7.4) and serving (item 10); they
raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import runtime

__all__ = ["LAYER_GROUP", "REMAT_TODO", "init_block", "block_apply",
           "init_lm", "forward", "lm_loss"]

#: The dense family's one layer group (MoE models add a ``prefix`` group).
LAYER_GROUP = "layers.body."
REMAT_TODO = ("remat= (gradient checkpointing) is not ported yet "
              "(ROADMAP.md, queue 1 item 7.4)")
_VLM_TODO = ("the vlm family is not ported yet (ROADMAP.md, queue 1 item "
             "7.3)")


def _sub(params: dict, prefix: str) -> dict:
    """The leaves under ``prefix`` (``"attn."``, say), prefix dropped."""
    return {k[len(prefix):]: v for k, v in params.items()
            if k.startswith(prefix)}


def _check_family(cfg: ModelConfig) -> None:
    if cfg.attn == "mla" or cfg.moe is not None:
        raise NotImplementedError(L.MLA_MOE_TODO)
    if cfg.family == "vlm":
        raise NotImplementedError(_VLM_TODO)


# --------------------------------------------------------------------------
# one block
# --------------------------------------------------------------------------


def init_block(cfg: ModelConfig, gen: torch.Generator,
               layer_idx: int = 0) -> dict:
    """One pre-norm block's parameters, flat (``ln_attn.scale``,
    ``attn.wq``, ``mlp.w_up``, ...)."""
    _check_family(cfg)
    dtype = L._dtype(cfg.param_dtype)
    parts = {"ln_attn": L.init_norm(cfg, dtype, gen.device),
             "ln_mlp": L.init_norm(cfg, dtype, gen.device),
             "attn": L.init_attention(cfg, gen),
             "mlp": L.init_mlp(cfg, gen)}
    return {f"{name}.{k}": v for name, part in parts.items()
            for k, v in part.items()}


def block_apply(cfg: ModelConfig, params: dict, x: torch.Tensor,
                positions: torch.Tensor, window: int = 0):
    """Pre-norm block. Returns ``(x, None, aux_loss)``, as the reference's
    full-sequence path does."""
    h = L.apply_norm(cfg, _sub(params, "ln_attn."), x)
    attn_out, _ = L.attention_apply(cfg, _sub(params, "attn."), h,
                                    positions, window=window)
    x = x + attn_out
    h = L.apply_norm(cfg, _sub(params, "ln_mlp."), x)
    mlp_out = L.mlp_apply(cfg, _sub(params, "mlp."), h)
    return x + mlp_out, None, torch.zeros((), dtype=torch.float32,
                                          device=x.device)


# --------------------------------------------------------------------------
# full model
# --------------------------------------------------------------------------


def _stack_layers(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Every layer's parameters, stacked on a leading ``layers`` axis."""
    blocks = [init_block(cfg, gen, layer_idx=i) for i in range(cfg.n_layers)]
    return {f"{LAYER_GROUP}{k}": torch.stack([b[k] for b in blocks])
            for k in blocks[0]}


def init_lm(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """The LM's parameters (flat, see the module docstring), drawn from
    ``gen`` on its device in ``cfg.param_dtype``."""
    _check_family(cfg)
    dtype = L._dtype(cfg.param_dtype)
    params = {"embed": L.dense_init(gen, (cfg.vocab, cfg.d_model), dtype,
                                    in_axis_sizes=cfg.d_model,
                                    scale=cfg.d_model ** -0.5)}
    params.update(_stack_layers(cfg, gen))
    params.update({f"ln_f.{k}": v for k, v in
                   L.init_norm(cfg, dtype, gen.device).items()})
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, (cfg.d_model, cfg.vocab),
                                         dtype)
    return params


def _embed(cfg: ModelConfig, params: dict, tokens: torch.Tensor
           ) -> torch.Tensor:
    cdt = L._dtype(cfg.compute_dtype)
    x = torch.nn.functional.embedding(tokens, params["embed"]).to(cdt)
    if cfg.name.startswith("gemma"):
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cdt, device=x.device)
    return x


def _blocks(cfg: ModelConfig, params: dict, x: torch.Tensor,
            positions: torch.Tensor, window: int):
    """The reference's layer scan: one block per slice of the stacked
    leaves. Returns ``(x, aux_sum)``."""
    stacked = _sub(params, LAYER_GROUP)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(next(iter(stacked.values())).shape[0]):
        x, _, a = block_apply(cfg, {k: v[i] for k, v in stacked.items()}, x,
                              positions, window=window)
        aux = aux + a
    return x, aux


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            positions: torch.Tensor | None = None, patches=None,
            window: int = 0, remat: bool = False,
            return_hidden: bool = False):
    """Full-sequence forward. Returns ``(logits, aux_loss)``, or with
    ``return_hidden`` the final-norm hidden states ``(B, S, D)`` instead of
    the logits."""
    _check_family(cfg)
    if remat:
        raise NotImplementedError(REMAT_TODO)
    if patches is not None:
        raise NotImplementedError(_VLM_TODO)
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        positions = positions[None, :].expand(tokens.shape)
    x = _embed(cfg, params, tokens)
    x, aux = _blocks(cfg, params, x, positions, window)
    x = L.apply_norm(cfg, _sub(params, "ln_f."), x)
    if return_hidden:
        return x, aux
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x, params["embed"].to(x.dtype))
    else:
        logits = torch.einsum("bsd,dv->bsv", x,
                              params["lm_head"].to(x.dtype))
    return logits.to(L._dtype(cfg.logit_dtype)), aux


def lm_loss(cfg: ModelConfig, params: dict, batch: dict,
            remat: bool = False) -> torch.Tensor:
    """Next-token cross entropy (+ aux). batch: ``tokens``, ``labels``.

    Under an active :func:`repro_torch.models.runtime.kernel_scope` the
    NLL is computed by :func:`repro_torch.kernels.ops.cross_entropy` on
    the final hidden states; otherwise by a log-softmax of the logits."""
    labels = batch["labels"]
    kb = runtime.kernel_backend()
    if kb is not None:
        x, aux = forward(cfg, params, batch["tokens"],
                         patches=batch.get("patches"), remat=remat,
                         return_hidden=True)
        w = (params["embed"].T if cfg.tie_embeddings
             else params["lm_head"]).to(x.dtype)
        b, s, d = x.shape
        nll = ops.cross_entropy(x.reshape(b * s, d), w, labels.reshape(-1),
                                backend=kb)
        return torch.mean(nll) + aux
    logits, aux = forward(cfg, params, batch["tokens"],
                          patches=batch.get("patches"), remat=remat)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    return torch.mean(nll) + aux
