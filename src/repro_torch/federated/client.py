"""Client-side local training: E local steps of the optimizer on a shard.

Port of :mod:`repro.federated.client`. :func:`local_train` is the plain
statement for one client (a dict of parameters in, a new dict out).
:func:`make_local_train` is the batched form the campaign engine runs:
every (scenario, client) replica at once, through ``torch.func`` (``vmap``
over scenarios, ``vmap`` over clients, ``grad`` of the loss), with the
clients' data shared by every scenario.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.func import grad_and_value, vmap

from repro_torch.optim.base import Optimizer, apply_updates

__all__ = ["local_train", "make_local_train"]


def _step(batches: dict, s: int) -> dict:
    return {k: v[s] for k, v in batches.items()}


def local_train(loss_fn: Callable, params: dict, batches: dict,
                opt: Optimizer):
    """One optimizer step per leading-axis slice of ``batches``.

    batches: dict whose leaves have leading axis = number of local steps.
    Returns ``(new_params, losses (steps,))``.
    """
    state = opt.init(params)
    losses = []
    for s in range(next(iter(batches.values())).shape[0]):
        grads, loss = grad_and_value(loss_fn)(params, _step(batches, s))
        updates, state = opt.update(grads, state, params)
        params = apply_updates(params, updates)
        losses.append(loss)
    return params, torch.stack(losses)


def make_local_train(loss_fn: Callable, opt: Optimizer):
    """Returns ``fn(params, batches) -> (params, losses)`` over replicas.

    ``params`` leaves are ``(B, N, ...)`` — one replica per (scenario,
    client) — and ``batches`` leaves ``(N, steps, ...)``, client ``i``'s
    data shared by every scenario. ``fn`` writes each step's result into
    ``params``' own tensors in place (the campaign engine hands over views
    of its flat client slab) and returns them with the ``(B, N, steps)``
    losses. The arithmetic, float32 round trips included, is
    :func:`local_train`'s.
    """
    per_client = vmap(grad_and_value(loss_fn), in_dims=(0, 0))
    per_replica = vmap(per_client, in_dims=(0, None))

    def fn(params: dict, batches: dict):
        state = opt.init(params)
        losses = []
        for s in range(next(iter(batches.values())).shape[1]):
            batch = {k: v[:, s] for k, v in batches.items()}
            grads, loss = per_replica(params, batch)
            updates, state = opt.update(grads, state, params)
            for k, new in apply_updates(params, updates).items():
                params[k].copy_(new)
            losses.append(loss)
        return params, torch.stack(losses, dim=-1)

    return fn
