"""Deterministic synthetic image task (no dataset download).

Port of :class:`repro.data.synthetic.SyntheticCifar`: a learnable
10-class task standing in for CIFAR-10 — class templates plus per-sample
Gaussian noise, in float64 with int64 labels as the reference makes them
under x64. Every draw comes from a ``torch.Generator`` on the dataset's
device keyed by (seed, stream, client, round), so a client's shard is
stateless in those, as the reference's folded keys are. The numbers differ
from the reference's (another generator); parity tests hand the
reference's batches across instead. ``SyntheticLM`` comes with the models
and ``dataset`` with ``data/partition.py`` (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.device import resolve_device
from repro_torch.rng import generator

__all__ = ["SyntheticCifar"]

_TEMPLATES, _VAL, _CLIENT = 0, 10_007, 1


@dataclasses.dataclass(frozen=True)
class SyntheticCifar:
    n_classes: int = 10
    image_shape: tuple = (32, 32, 3)
    noise: float = 0.8          # template SNR; higher = harder
    n_train: int = 50_000       # paper: 50k train
    n_val: int = 7_000          # paper: 7k validation
    seed: int = 0
    device: str | torch.device = "cuda"

    @functools.cached_property
    def _device(self) -> torch.device:
        return resolve_device(self.device)

    @functools.cached_property
    def templates(self) -> torch.Tensor:
        """``(n_classes, *image_shape)`` float64 class templates."""
        gen = generator(self._device, self.seed, _TEMPLATES)
        return torch.randn((self.n_classes, *self.image_shape), generator=gen,
                           dtype=torch.float64, device=self._device)

    def batch(self, gen: torch.Generator, shape: tuple[int, ...]) -> dict:
        """``shape`` examples (e.g. ``(n,)`` or ``(steps, n)``) drawn from
        ``gen``: labels, then ``template[label] + noise``."""
        labels = torch.randint(0, self.n_classes, shape, generator=gen,
                               device=self._device)
        noise = torch.randn((*shape, *self.image_shape), generator=gen,
                            dtype=torch.float64, device=self._device)
        return {"images": self.templates[labels] + noise * self.noise,
                "labels": labels}

    def val_set(self, n: int | None = None) -> dict:
        n = n or min(self.n_val, 1024)
        return self.batch(generator(self._device, self.seed, _VAL), (n,))

    def client_batch(self, client_id: int, round_idx: int, n: int,
                     steps: int | None = None) -> dict:
        """Deterministic per-(client, round) shard — the iid partition:
        ``(n, ...)`` examples, or ``(steps, n, ...)`` with ``steps``."""
        gen = generator(self._device, self.seed, _CLIENT, client_id,
                        round_idx)
        return self.batch(gen, (n,) if steps is None else (steps, n))
