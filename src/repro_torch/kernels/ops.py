"""Backend dispatch for the port's kernels.

Port of :mod:`repro.kernels.ops` (resolution and telemetry, the
Poisson-binomial wrappers and the FedAvg merge). Every dispatched call has
two implementations:

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
"""
from __future__ import annotations

import contextlib
import os
import sys

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.fedavg_agg import fedavg_agg
from repro_torch.kernels.poibin_dft import poibin_dft

__all__ = ["BACKENDS", "ENV_VAR", "resolve_backend", "set_backend",
           "backend_scope", "dispatch_stats", "reset_dispatch_stats",
           "poibin", "poibin_pmf", "fedavg", "fedavg_merge"]

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
