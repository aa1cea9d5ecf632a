"""The synthetic FL task every campaign caller of the repository uses.

Port of :func:`repro.federated.tasks.synthetic_mlp_task` and
:class:`repro.federated.tasks.FLTask`: 8x8x3 template+noise images
(:class:`repro_torch.data.SyntheticCifar`), a 1-hidden-layer MLP, float64
parameters and images, int64 labels. ``model_task`` comes with the models
(ROADMAP.md, queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.data.synthetic import SyntheticCifar
from repro_torch.device import resolve_device
from repro_torch.rng import generator

__all__ = ["FLTask", "synthetic_mlp_task"]

_CLIENT_STREAM = 1


@dataclasses.dataclass(frozen=True)
class FLTask:
    """One FL task, bundled for the campaign engine.

    ``campaign_args()`` splats into
    :func:`repro_torch.federated.campaign.run_campaigns`. The callables:

    * ``init_params(gen) -> dict`` — float64 parameters drawn from the
      ``torch.Generator`` ``gen``, on its device;
    * ``loss_fn(params, batch)`` / ``eval_fn(params, batch)`` — one
      replica's loss and accuracy (0-d tensors), written for
      ``torch.func`` (``vmap``, ``grad``);
    * ``client_data(cids, rnd, n, steps) -> dict`` — round ``rnd``'s
      shards of the clients ``cids``, leaves ``(len(cids), steps, n, ...)``;
    * ``val_batch`` — the validation batch.
    """

    data: Any
    init_params: Callable[[torch.Generator], dict]
    loss_fn: Callable
    eval_fn: Callable
    client_data: Callable
    val_batch: dict

    def campaign_args(self) -> tuple:
        """The positional task args of the campaign-engine entry points."""
        return (self.init_params, self.loss_fn, self.eval_fn,
                self.client_data, self.val_batch)


def synthetic_mlp_task(
    image_shape: tuple = (8, 8, 3),
    hidden: int = 16,
    noise: float = 3.0,
    val_size: int = 128,
    data_seed: int = 0,
    *,
    device: str | torch.device = "cuda",
) -> FLTask:
    """A small learnable 10-class task (CIFAR stand-in) + 1-hidden-layer MLP.

    Args:
        image_shape: synthetic image shape (default 8x8x3).
        hidden: MLP hidden width.
        noise: template SNR — higher is harder.
        val_size: validation batch size.
        data_seed: seed of the per-(client, round) iid data streams.
        device: where the data is made (default ``"cuda"``).

    At the defaults the model has P = 3,258 parameters: ``w1 (192, 16)``,
    ``b1 (16,)``, ``w2 (16, 10)``, ``b2 (10,)``. Client ``c``'s shard of
    round ``r`` depends on (``data_seed``, c, r) only, never on the
    scenario, so a campaign draws it once per round for all scenarios.
    """
    dev = resolve_device(device)
    data = SyntheticCifar(noise=noise, image_shape=tuple(image_shape),
                          device=dev)
    d = int(np.prod(image_shape))

    def init_params(gen: torch.Generator) -> dict:
        kw = dict(generator=gen, dtype=torch.float64, device=gen.device)
        w1 = torch.randn((d, hidden), **kw) * d ** -0.5
        w2 = torch.randn((hidden, 10), **kw) * hidden ** -0.5
        return {"w1": w1,
                "b1": torch.zeros(hidden, dtype=torch.float64,
                                  device=gen.device),
                "w2": w2,
                "b2": torch.zeros(10, dtype=torch.float64, device=gen.device)}

    def fwd(p, x):
        h = torch.relu(x.reshape(x.shape[0], -1) @ p["w1"] + p["b1"])
        return h @ p["w2"] + p["b2"]

    def loss_fn(p, b):
        lp = torch.log_softmax(fwd(p, b["images"]), dim=-1)
        return -torch.mean(torch.gather(lp, 1, b["labels"][:, None]))

    def eval_fn(p, b):
        hit = torch.argmax(fwd(p, b["images"]), dim=-1) == b["labels"]
        return torch.mean(hit.to(torch.float64))

    def client_data(cids: Sequence[int], rnd: int, n: int,
                    steps: int) -> dict:
        shards = [data.batch(generator(dev, data_seed, _CLIENT_STREAM,
                                       int(c), int(rnd)), (steps, n))
                  for c in cids]
        return {k: torch.stack([s[k] for s in shards]) for k in shards[0]}

    return FLTask(data=data, init_params=init_params, loss_fn=loss_fn,
                  eval_fn=eval_fn, client_data=client_data,
                  val_batch=data.val_set(val_size))
