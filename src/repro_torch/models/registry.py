"""Uniform model API: config -> init / loss / logits.

Port of :mod:`repro.models.registry` for the dense transformer family. The
FL substrate talks to :class:`ModelApi` only. The reference's API also
carries the decode entry points (``serve_step``, ``init_cache``,
``input_specs``, ``cache_kind``); serving is ROADMAP.md queue 1 item 10.
Every family but ``"dense"`` raises ``NotImplementedError`` naming its
item of queue 1.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer

__all__ = ["ModelApi", "get_model", "param_count", "FAMILY_TODO"]

#: ROADMAP.md queue 1 item of every family that is not ported yet.
FAMILY_TODO = {
    "ssm": "7.1 (rwkv, with the rwkv6_scan kernel)",
    "hybrid": "7.2 (hybrid/ssm, with the ssm_scan kernel)",
    "moe": "7.3 (MoE / MLA / VLM / encdec / resnet)",
    "vlm": "7.3 (MoE / MLA / VLM / encdec / resnet)",
    "audio": "7.3 (MoE / MLA / VLM / encdec / resnet)",
    "vision": "7.3 (MoE / MLA / VLM / encdec / resnet)",
}


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ModelConfig
    #: ``init(gen) -> params``: the flat parameter dict drawn from a
    #: ``torch.Generator`` on its device
    init: Callable[[torch.Generator], dict]
    #: ``loss(params, batch, remat=False) -> 0-d float32``
    loss: Callable[..., torch.Tensor]
    #: ``logits(params, batch)``: per-position logits aligned with
    #: ``batch["labels"]`` (``(B, S, V)``), the evaluation accessor
    logits: Callable[[dict, dict], torch.Tensor]


def get_model(cfg: ModelConfig) -> ModelApi:
    fam = cfg.family
    if fam == "dense":
        return _transformer_api(cfg)
    if fam in FAMILY_TODO:
        raise NotImplementedError(
            f"model family {fam!r} is not ported yet (ROADMAP.md, queue 1 "
            f"item {FAMILY_TODO[fam]})")
    raise ValueError(f"unknown family {fam}")


def _transformer_api(cfg: ModelConfig) -> ModelApi:
    def loss(params, batch, remat=False):
        return transformer.lm_loss(cfg, params, batch, remat=remat)

    def logits(params, batch):
        return transformer.forward(cfg, params, batch["tokens"])[0]

    return ModelApi(cfg=cfg,
                    init=lambda gen: transformer.init_lm(cfg, gen),
                    loss=loss, logits=logits)


def param_count(params: dict) -> int:
    return sum(int(x.numel()) for x in params.values())
