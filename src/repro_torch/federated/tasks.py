"""FL tasks for the campaign engine.

Port of :class:`repro.federated.tasks.FLTask`,
:func:`repro.federated.tasks.synthetic_mlp_task` (8x8x3 template+noise
images from :class:`repro_torch.data.SyntheticCifar`, a 1-hidden-layer
MLP, float64 parameters and images, int64 labels) and
:func:`repro.federated.tasks.model_task` (any ported model of
:mod:`repro_torch.models.registry` — the dense transformer family today —
on :class:`repro_torch.data.SyntheticLM` token streams, parameters in the
config's dtype, int64 tokens and labels).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.data.synthetic import SyntheticCifar, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models import runtime
from repro_torch.models.registry import get_model
from repro_torch.models.transformer import REMAT_TODO
from repro_torch.rng import generator

__all__ = ["FLTask", "synthetic_mlp_task", "model_task"]

_CLIENT_STREAM = 1


@dataclasses.dataclass(frozen=True)
class FLTask:
    """One FL task, bundled for the campaign engine.

    ``campaign_args()`` splats into
    :func:`repro_torch.federated.campaign.run_campaigns`. The callables:

    * ``init_params(gen) -> dict`` — parameters (float64 for the MLP, the
      config's dtype for a model) drawn from the ``torch.Generator``
      ``gen``, on its device;
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
    #: model config behind the task (None for the hand-rolled MLP task)
    cfg: Any = None
    #: suggested optimizer (None -> the caller picks); informational only:
    #: ``campaign_args()`` stays the five engine callables
    opt: Any = None

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


_DIRICHLET_TODO = ("partition='dirichlet' is not ported yet (ROADMAP.md, "
                   "queue 1 item 4: data/partition.py)")


def model_task(
    cfg,
    shape=None,
    *,
    backend: str | None = None,
    optimizer=None,
    partition: str = "iid",
    val_size: int = 64,
    data_seed: int = 0,
    remat: bool = False,
    device: str | torch.device = "cuda",
) -> FLTask:
    """Wrap a ported :class:`~repro_torch.models.registry.ModelApi` as an FL
    task.

    Args:
        cfg: a :class:`~repro_torch.configs.base.ModelConfig` of a ported
            family (``"dense"``; the others raise ``NotImplementedError``
            naming their ROADMAP item, vision, vlm and audio frontends
            included).
        shape: sequence length — an int, a
            :class:`~repro_torch.configs.base.ShapeSpec` (its ``seq_len``),
            or None for the 16-token default.
        backend: model-kernel backend of the *training* loss, entered with
            :func:`repro_torch.models.runtime.kernel_scope`: ``None`` keeps
            the plain model code, ``"ref"`` routes attention and the
            cross-entropy through the oracles of
            :mod:`repro_torch.kernels.ops`, ``"kernel"`` through the CUDA
            kernels (their plain versions on CPU tensors) with the oracles'
            VJP backward. Evaluation always runs the plain path.
        optimizer: stored on the task (informational).
        partition: ``"iid"``: stateless per-(client, round) streams of
            ``SyntheticLM(vocab=cfg.vocab, seed=data_seed)``.
            ``"dirichlet"`` raises ``NotImplementedError`` (ROADMAP.md
            queue 1 item 4; the reference's ``alpha``, ``n_clients`` and
            ``dataset_size`` come with it).
        val_size: validation batch size.
        data_seed: seed of the data source and the client streams.
        remat: gradient checkpointing; ``True`` raises
            ``NotImplementedError`` (ROADMAP.md queue 1 item 7.4).
        device: where the data is made (default ``"cuda"``).

    Returns:
        An :class:`FLTask` whose ``client_data(cids, rnd, n, steps)`` gives
        ``tokens``/``labels`` of shape ``(len(cids), steps, n, seq)``,
        deterministic in (``data_seed``, client, round). The Markov chain
        of all the clients runs once, over the stacked draws.
    """
    if partition == "dirichlet":
        raise NotImplementedError(_DIRICHLET_TODO)
    if partition != "iid":
        raise ValueError(f"unknown partition {partition!r}; "
                         f"expected 'iid' or 'dirichlet'")
    if remat:
        raise NotImplementedError(REMAT_TODO)
    api = get_model(cfg)
    dev = resolve_device(device)
    if isinstance(shape, int):
        seq = shape
    elif shape is not None:
        seq = shape.seq_len
    else:
        seq = 16
    data = SyntheticLM(vocab=cfg.vocab, seed=data_seed, device=dev)

    def loss_fn(p, b):
        with runtime.kernel_scope(backend):
            return api.loss(p, b)

    def eval_fn(p, b):      # a float32 mean, as the reference's
        hit = torch.argmax(api.logits(p, b), dim=-1) == b["labels"]
        return torch.mean(hit.to(torch.float32))

    def client_data(cids: Sequence[int], rnd: int, n: int,
                    steps: int) -> dict:
        draws = [data.draws(generator(dev, data_seed, _CLIENT_STREAM, int(c),
                                      int(rnd)), (steps, n), seq)
                 for c in cids]
        return data.chain(*(torch.stack(x) for x in zip(*draws)))

    return FLTask(data=data, init_params=api.init, loss_fn=loss_fn,
                  eval_fn=eval_fn, client_data=client_data,
                  val_batch=data.val_set(val_size, seq), cfg=cfg,
                  opt=optimizer)
