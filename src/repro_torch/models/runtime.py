"""Call-time model knobs.

Port of :mod:`repro.models.runtime`. In the reference the knobs are read
while a function is traced; PyTorch runs eagerly, so here they are read at
every call, with the same meaning.

``KERNEL_BACKEND`` picks the implementation of the model's hot paths
(attention and the cross-entropy of the loss):

* ``None`` (default) — the plain model code (einsum attention, dense
  logits and log-softmax);
* ``"ref"`` — the :mod:`repro_torch.kernels.ops` wrappers pinned to their
  plain oracles;
* ``"kernel"`` — the hand-written CUDA kernels (on a CPU tensor, their
  plain versions), differentiable through the oracles' VJP.

The reference's ``SCAN_UNROLL`` and ``ATTN_IMPL`` knobs steer its traced
layer scan and the flash switch of its dry run; the port loops over layers
in Python and reaches the kernels through ``kernel_scope`` only.
"""
from __future__ import annotations

import contextlib

__all__ = ["KERNEL_BACKEND", "kernel_backend", "kernel_scope"]

KERNEL_BACKEND: str | None = None


def kernel_backend() -> str | None:
    """The active model-kernel backend (``None`` = plain model code)."""
    return KERNEL_BACKEND


@contextlib.contextmanager
def kernel_scope(backend: str | None):
    """Pin the model-kernel backend inside the ``with`` block.

    ``kernel_scope(None)`` is the plain-model default, so callers can
    thread an optional backend without branching.
    """
    global KERNEL_BACKEND
    if backend not in (None, "kernel", "ref"):
        raise ValueError(f"kernel backend {backend!r} not in "
                         f"(None, 'kernel', 'ref')")
    prev = KERNEL_BACKEND
    KERNEL_BACKEND = backend
    try:
        yield
    finally:
        KERNEL_BACKEND = prev
