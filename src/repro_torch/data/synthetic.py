"""Deterministic synthetic datasets (no dataset download).

Ports of :class:`repro.data.synthetic.SyntheticCifar` — a learnable
10-class task standing in for CIFAR-10: class templates plus per-sample
Gaussian noise, in float64 with int64 labels as the reference makes them
under x64 — and :class:`repro.data.synthetic.SyntheticLM`, a Markov token
stream for the language models. Every draw comes from a
``torch.Generator`` on the dataset's device keyed by (seed, stream,
client, round), so a client's shard is stateless in those, as the
reference's folded keys are. The numbers differ from the reference's
(another generator); parity tests hand the reference's batches across
instead. ``dataset`` comes with ``data/partition.py`` (ROADMAP.md, queue 1
item 4).
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.device import resolve_device
from repro_torch.rng import generator

__all__ = ["SyntheticCifar", "SyntheticLM"]

_TEMPLATES, _VAL, _CLIENT = 0, 10_007, 1
_SUCCESSORS = 0


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


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    """Markov-ish token stream: the next token is a fixed successor of the
    previous one (a seeded permutation of the vocabulary) with probability
    ``order_weight``, else a uniform random token. Tokens are int64."""

    vocab: int = 512
    order_weight: float = 0.7   # how predictable the stream is
    seed: int = 0
    device: str | torch.device = "cuda"

    @functools.cached_property
    def _device(self) -> torch.device:
        return resolve_device(self.device)

    @functools.cached_property
    def succ(self) -> torch.Tensor:
        """``(vocab,)`` successor table, a permutation drawn from ``seed``."""
        return torch.randperm(self.vocab, device=self._device,
                              generator=generator(self._device, self.seed,
                                                  _SUCCESSORS))

    def draws(self, gen: torch.Generator, shape: tuple[int, ...],
              seq: int) -> tuple[torch.Tensor, ...]:
        """The random inputs of ``shape`` sequences of length ``seq`` drawn
        from ``gen``: start tokens ``shape``, noise coins and random tokens
        ``shape + (seq,)``."""
        kw = dict(generator=gen, device=self._device)
        start = torch.randint(0, self.vocab, shape, **kw)
        noisy = torch.rand((*shape, seq), **kw) > self.order_weight
        rand = torch.randint(0, self.vocab, (*shape, seq), **kw)
        return start, noisy, rand

    def chain(self, start: torch.Tensor, noisy: torch.Tensor,
              rand: torch.Tensor) -> dict:
        """Run the Markov chain over the positions of :meth:`draws`' inputs
        (any leading shape): ``labels`` are the chain's tokens, ``tokens``
        the same shifted right behind the start token."""
        seq = noisy.shape[-1]
        toks = torch.empty_like(rand)
        tok = start
        for t in range(seq):
            tok = torch.where(noisy[..., t], rand[..., t], self.succ[tok])
            toks[..., t] = tok
        tokens = torch.cat([start[..., None], toks[..., :-1]], dim=-1)
        return {"tokens": tokens, "labels": toks}

    def batch(self, gen: torch.Generator, shape: tuple[int, ...],
              seq: int) -> dict:
        """``shape`` sequences (e.g. ``(n,)`` or ``(steps, n)``) drawn from
        ``gen``: ``tokens`` and ``labels``, ``shape + (seq,)``."""
        return self.chain(*self.draws(gen, shape, seq))

    def client_batch(self, client_id: int, round_idx: int, n: int, seq: int,
                     steps: int | None = None) -> dict:
        """Deterministic per-(client, round) shard — the iid partition."""
        gen = generator(self._device, self.seed, _CLIENT, client_id,
                        round_idx)
        return self.batch(gen, (n,) if steps is None else (steps, n), seq)

    def val_set(self, n: int, seq: int) -> dict:
        return self.batch(generator(self._device, self.seed, _VAL), (n,),
                          seq)
