"""Explicit random streams: a ``torch.Generator`` per named stream.

The reference draws from keyed ``jax.random`` streams (``PRNGKey(seed)``
folded with a stream offset, a client id, a round). The port does not
reproduce threefry; it keys a ``torch.Generator`` on the run's device with
a 63-bit seed hashed from the same parts, so every stream is deterministic
in its parts and independent of the order in which streams are drawn.
CPU and CUDA generators give different numbers from one seed.
"""
from __future__ import annotations

import hashlib

import torch

__all__ = ["generator"]


def generator(device: torch.device | str, *parts: int) -> torch.Generator:
    """A fresh ``torch.Generator`` on ``device`` seeded with a 63-bit hash
    of ``parts`` (Python ints)."""
    digest = hashlib.blake2b(repr(tuple(int(x) for x in parts)).encode(),
                             digest_size=8).digest()
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int.from_bytes(digest, "little") >> 1)
    return gen
