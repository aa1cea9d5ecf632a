"""Backend dispatch for the port's kernels.

Port of :mod:`repro.kernels.ops` (resolution and telemetry, the
Poisson-binomial wrappers, the FedAvg merge, attention and the fused
cross-entropy). Every dispatched call has two implementations:

* ``backend="kernel"`` — the hand-written CUDA kernel. For a tensor on the
  CPU its wrapper runs the kernel's plain version instead (same fp32
  arithmetic policy); for a CUDA tensor it launches the kernel or raises.
* ``backend="ref"`` — the plain PyTorch oracle in the input dtype
  (:mod:`repro_torch.kernels.ref`), or at the game-layer call sites the f64
  recursive program.

Backend resolution order (first hit wins):

1. the explicit ``backend=`` argument of the call,
2. a process-wide override installed with :func:`set_backend` (or
   temporarily via :func:`backend_scope`),
3. the ``REPRO_TORCH_KERNEL_BACKEND`` environment variable (its own name:
   the reference's ``REPRO_KERNEL_BACKEND`` would be read — and, holding a
   port-only value, ignored with a warning — by the JAX resolver),
4. the call site's default.

PyTorch runs eagerly, so resolution happens at every call and every
resolution with a ``site`` is counted (:func:`dispatch_stats`).

The model kernels (:func:`attention`, :func:`cross_entropy`) compute a
forward pass only, as in the reference. Their kernel backend is a
``torch.autograd.Function`` — the twin of the reference's
``_pallas_fwd_ref_bwd`` (``repro/kernels/ops.py:69-88``): the forward runs
the kernel, the backward is ``torch.func.vjp`` of the plain oracle at the
saved inputs. Its ``vmap`` rule folds every vmapped dimension into the
kernel's leading batch axis, so ``vmap(vmap(grad(loss)))`` over (scenario,
client) replicas ends in one launch per call.
"""
from __future__ import annotations

import contextlib
import os
import sys

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.fedavg_agg import fedavg_agg
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.fused_ce import fused_ce
from repro_torch.kernels.poibin_dft import poibin_dft

__all__ = ["BACKENDS", "ENV_VAR", "resolve_backend", "set_backend",
           "backend_scope", "dispatch_stats", "reset_dispatch_stats",
           "poibin", "poibin_pmf", "fedavg", "fedavg_merge", "attention",
           "cross_entropy"]

BACKENDS = ("kernel", "ref")
ENV_VAR = "REPRO_TORCH_KERNEL_BACKEND"

_override: str | None = None   # set_backend() state; beats the env var
_env_warned = False            # warn-once latch for a bogus env value

#: (call_site, backend) -> number of resolutions.
_dispatch_counts: dict[tuple[str, str], int] = {}


def _validate(backend: str) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    return backend


def _env_backend() -> str | None:
    """The env-var backend, or ``None`` — warning once on a bogus value."""
    global _env_warned
    env = os.environ.get(ENV_VAR)
    if not env:
        return None
    if env not in BACKENDS:
        if not _env_warned:
            print(f"repro_torch.kernels.ops: ignoring {ENV_VAR}={env!r} "
                  f"(unknown backend; expected one of {BACKENDS})",
                  file=sys.stderr)
            _env_warned = True
        return None
    return env


def resolve_backend(backend: str | None = None, *,
                    default: str = "kernel",
                    site: str | None = None) -> str:
    """Resolve a ``backend=`` argument to ``"kernel"`` or ``"ref"``.

    Precedence: the argument (invalid values raise ``ValueError``), then
    :func:`set_backend`/:func:`backend_scope`, then the
    ``REPRO_TORCH_KERNEL_BACKEND`` environment variable (an unknown value
    is ignored with a one-time stderr warning), then ``default``. With
    ``site`` the ``(site, backend)`` counter of :func:`dispatch_stats`
    goes up by one.
    """
    resolved = _resolve(backend, default)
    if site is not None:
        key = (site, resolved)
        _dispatch_counts[key] = _dispatch_counts.get(key, 0) + 1
    return resolved


def _resolve(backend: str | None, default: str) -> str:
    if backend is not None:
        return _validate(backend)
    if _override is not None:
        return _override
    env = _env_backend()
    if env is not None:
        return env
    return _validate(default)


def dispatch_stats() -> dict[str, dict[str, int]]:
    """Dispatch counters: ``{site: {backend: count}}``."""
    out: dict[str, dict[str, int]] = {}
    for (site, backend), count in sorted(_dispatch_counts.items()):
        out.setdefault(site, {})[backend] = count
    return out


def reset_dispatch_stats() -> None:
    """Zero the dispatch counters (start of a measured region)."""
    _dispatch_counts.clear()


def set_backend(backend: str | None) -> str | None:
    """Install a process-wide backend override (``None`` clears it).

    Returns the previous override so callers can restore it; prefer
    :func:`backend_scope` for temporary pinning.
    """
    global _override
    prev = _override
    _override = None if backend is None else _validate(backend)
    return prev


@contextlib.contextmanager
def backend_scope(backend: str):
    """Context manager pinning every dispatched call inside to ``backend``."""
    prev = set_backend(backend)
    try:
        yield
    finally:
        set_backend(prev)


def poibin(p_mat: torch.Tensor, *, backend: str | None = None):
    """DFT pmf + all leave-one-out pmfs for a (B, N) probability matrix.

    Returns ``(pmf (B, N+1), loo (B, N, N+1))`` in ``p_mat``'s dtype. The
    kernel's arithmetic is fp32; ``"ref"`` runs the plain version in the
    input dtype.
    """
    if resolve_backend(backend, site="ops.poibin") == "ref":
        return ref.poibin_dft_ref(p_mat)
    return poibin_dft(p_mat, with_loo=True)


def poibin_pmf(p_mat: torch.Tensor, *, backend: str | None = None):
    """(B, N) probability matrix -> (B, N+1) pmfs (the pmf-only variant)."""
    if resolve_backend(backend, site="ops.poibin_pmf") == "ref":
        return ref.poibin_dft_ref(p_mat, with_loo=False)
    return poibin_dft(p_mat, with_loo=False)


def fedavg(global_flat: torch.Tensor, client_flat: torch.Tensor,
           mask: torch.Tensor, *, backend: str | None = None,
           site: str = "ops.fedavg") -> torch.Tensor:
    """Masked FedAvg merge on flat parameters.

    global_flat ``(P,)`` or ``(B, P)``; client_flat ``(N, P)`` or
    ``(B, N, P)``; mask ``(N,)`` or ``(B, N)``, bool or float (pre-scaled
    weights) -> the global's shape and dtype. Ragged P, N = 1 and the
    all-zero mask (previous-global fallback) are handled by both backends.
    """
    if resolve_backend(backend, site=site) == "ref":
        return ref.fedavg_agg_ref(global_flat, client_flat, mask)
    return fedavg_agg(global_flat, client_flat, mask)


def fedavg_merge(global_params: dict, client_params: dict,
                 mask: torch.Tensor, *,
                 backend: str | None = None) -> dict:
    """Flat-kernel twin of :func:`repro_torch.federated.server.fedavg_merge`
    (the reference's ``ops.fedavg_merge_pallas``).

    ``global_params`` leaves are ``(*batch, ...)``, ``client_params``
    leaves ``(*batch, N, ...)`` and ``mask`` is ``(*batch, N)``, with
    ``batch`` empty or ``(B,)``. A single leaf is passed to the kernel as
    it lies (a reshape, so no copy when it is contiguous): that is how the
    campaign engine hands over its flat ``(B, N, P)`` client slab. Several
    leaves are concatenated once — in their dtype when they share one,
    else in fp32 — and split back, each in its own dtype.
    """
    if mask.dim() not in (1, 2):
        raise ValueError(f"mask must be (N,) or (B, N), got "
                         f"{tuple(mask.shape)}")
    batch = tuple(mask.shape[:-1])
    n = mask.shape[-1]
    names = list(global_params)
    g_leaves = [global_params[k].reshape(*batch, -1) for k in names]
    c_leaves = [client_params[k].reshape(*batch, n, -1) for k in names]
    if len(names) == 1:
        g_flat, c_flat = g_leaves[0], c_leaves[0]
    else:
        dtypes = {x.dtype for x in g_leaves + c_leaves}
        dt = dtypes.pop() if len(dtypes) == 1 else torch.float32
        g_flat = torch.cat([x.to(dt) for x in g_leaves], dim=-1)
        c_flat = torch.cat([x.to(dt) for x in c_leaves], dim=-1)
    merged = fedavg(g_flat, c_flat, mask, backend=backend,
                    site="ops.fedavg_merge")
    out, off = {}, 0
    for k, g in zip(names, g_leaves):
        size = g.shape[-1]
        leaf = global_params[k]
        out[k] = merged[..., off:off + size].reshape(leaf.shape).to(leaf.dtype)
        off += size
    return out


# ---------------------------------------------------------------------------
# Model kernels: kernel forward, oracle-VJP backward, one launch under vmap
# ---------------------------------------------------------------------------

def _fold(x: torch.Tensor, bdim: int | None, n: int) -> torch.Tensor:
    """``x`` with its vmapped dimension ``bdim`` (or, if not batched at
    this level, an expanded one) moved to the front: ``(n, *logical)``."""
    if bdim is None:
        return x.expand(n, *x.shape)
    return x.movedim(bdim, 0)


class _Attention(torch.autograd.Function):
    """Flash-attention kernel forward, ``flash_attention_ref`` VJP backward."""

    @staticmethod
    def forward(q, k, v, causal, window):
        return flash_attention(q, k, v, causal=causal, window=window)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, ctx.causal, ctx.window = inputs
        ctx.save_for_backward(q, k, v)

    @staticmethod
    def backward(ctx, grad):
        def oracle(q, k, v):
            return ref.flash_attention_ref(q, k, v, causal=ctx.causal,
                                           window=ctx.window)

        _, vjp = torch.func.vjp(oracle, *ctx.saved_tensors)
        return (*vjp(grad), None, None)

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, window):
        n = info.batch_size
        q, k, v = (_fold(x, d, n).flatten(0, 1)
                   for x, d in zip((q, k, v), in_dims))
        out = _Attention.apply(q, k, v, causal, window)
        return out.unflatten(0, (n, -1)), 0


class _CrossEntropy(torch.autograd.Function):
    """Fused cross-entropy kernel forward, ``fused_ce_ref`` VJP backward."""

    @staticmethod
    def forward(hidden, w, labels):
        return fused_ce(hidden, w, labels)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, grad):
        hidden, w, labels = ctx.saved_tensors
        _, vjp = torch.func.vjp(
            lambda h, w: ref.fused_ce_ref(h, w, labels), hidden, w)
        return (*vjp(grad), None)

    @staticmethod
    def vmap(info, in_dims, hidden, w, labels):
        n = info.batch_size
        # logical hidden is (T, d), or (R, T, d) once an inner level folded
        lead = (hidden.dim() - (in_dims[0] is not None)) == 3
        args = [_fold(x, d, n) for x, d in zip((hidden, w, labels), in_dims)]
        if lead:
            args = [x.flatten(0, 1) for x in args]
        out = _CrossEntropy.apply(*args)
        return (out.unflatten(0, (n, -1)) if lead else out), 0


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0,
              backend: str | None = None) -> torch.Tensor:
    """Flash attention. q: ``(B, S, H, D)``; k, v: ``(B, S, KV, D)`` →
    ``(B, S, H, D)`` in q's dtype. ``"kernel"`` (default): the CUDA kernel
    forward (its plain version on CPU tensors), differentiable through the
    oracle; ``"ref"``: the oracle."""
    if resolve_backend(backend, site="ops.attention") == "ref":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    return _Attention.apply(q, k, v, causal, window)


def cross_entropy(hidden: torch.Tensor, w_vocab: torch.Tensor,
                  labels: torch.Tensor, *,
                  backend: str | None = None) -> torch.Tensor:
    """Fused per-token NLL without the ``(T, V)`` logits. hidden ``(T, d)``,
    w_vocab ``(d, V)``, labels ``(T,)`` → ``(T,)`` float32. Backends as in
    :func:`attention`."""
    if resolve_backend(backend, site="ops.cross_entropy") == "ref":
        return ref.fused_ce_ref(hidden, w_vocab, labels)
    return _CrossEntropy.apply(hidden, w_vocab, labels)
