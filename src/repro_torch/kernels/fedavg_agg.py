"""Participation-masked FedAvg merge kernel, batched over scenarios, CUDA.

Port of the Pallas TPU kernel ``src/repro/kernels/fedavg_agg.py:fedavg_agg``
as the hand-written CUDA C++ kernel ``csrc/fedavg_agg.cu`` (``sm_90a``,
bound with ``ctypes``; the source note there gives its design and bound).
One launch merges B scenarios: ``out[b] = Σ_i m[b,i] θ[b,i] / Σ_i m[b,i]``,
or the previous global ``g[b]`` cast through fp32 when ``Σ_i m[b,i] = 0``.

dtype policy, as in the reference: fp32 accumulation, output in the
global's dtype. The kernel reads fp32, fp64 and bf16 slabs as they lie
(the clients must share the global's dtype); the mask is cast to fp32
here. For tensors on the CPU the wrapper runs the plain version
(:func:`repro_torch.kernels.ref.fedavg_agg_ref`); for CUDA tensors it
launches the kernel or raises. :data:`counts` records both.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import build, ref

__all__ = ["DTYPES", "counts", "reset_counts", "fedavg_agg"]

#: dtypes the kernel reads, with their code in the C interface.
DTYPES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
_MAX_BATCH = 65_535          # the grid's y dimension


@dataclasses.dataclass
class _Counts:
    launches: int = 0   # kernel launches on CUDA tensors
    plain: int = 0      # calls served by the plain version (CPU tensors)


counts = _Counts()
_lib: ctypes.CDLL | None = None


def reset_counts() -> None:
    """Zero :data:`counts` (start of a measured region)."""
    counts.launches = 0
    counts.plain = 0


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("fedavg_agg")
        lib.fedavg_agg.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
            ctypes.c_void_p]
        lib.fedavg_agg.restype = ctypes.c_int
        lib.fedavg_agg_error_string.argtypes = [ctypes.c_int]
        lib.fedavg_agg_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(global_flat: torch.Tensor, client_flat: torch.Tensor,
           mask: torch.Tensor) -> None:
    if global_flat.dim() not in (1, 2):
        raise ValueError(f"global must be (P,) or (B, P), got "
                         f"{tuple(global_flat.shape)}")
    lead = tuple(global_flat.shape[:-1])
    p = global_flat.shape[-1]
    if client_flat.dim() != global_flat.dim() + 1 or \
            tuple(client_flat.shape[:len(lead)]) != lead or \
            client_flat.shape[-1] != p or client_flat.shape[-2] < 1:
        raise ValueError(f"clients {tuple(client_flat.shape)} do not match "
                         f"global {tuple(global_flat.shape)}: expected "
                         f"{lead + ('N',) + (p,)} with N >= 1")
    if tuple(mask.shape) != tuple(client_flat.shape[:-1]):
        raise ValueError(f"mask {tuple(mask.shape)} does not match clients "
                         f"{tuple(client_flat.shape)}")
    if global_flat.dtype not in DTYPES or client_flat.dtype != global_flat.dtype:
        raise TypeError(f"global and clients must share one of "
                        f"{list(DTYPES)}, got {global_flat.dtype} and "
                        f"{client_flat.dtype}")
    devices = {global_flat.device, client_flat.device, mask.device}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")


def fedavg_agg(global_flat: torch.Tensor, client_flat: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Masked FedAvg merge.

    Args:
        global_flat: ``(P,)`` or ``(B, P)`` previous global parameters.
        client_flat: ``(N, P)`` or ``(B, N, P)`` client parameters, in the
            global's dtype; on the card, contiguous (read as it lies).
        mask: ``(N,)`` or ``(B, N)``, bool participation or float
            participation·weight products.

    Returns:
        The merged parameters, shaped and typed like ``global_flat``.
    """
    _check(global_flat, client_flat, mask)
    if global_flat.device.type == "cpu":
        counts.plain += 1
        return ref.fedavg_agg_ref(global_flat, client_flat, mask)
    if global_flat.device.type != "cuda":
        raise ValueError(f"fedavg_agg runs on CUDA or CPU tensors, got "
                         f"{global_flat.device}")
    if not (global_flat.is_contiguous() and client_flat.is_contiguous()):
        raise ValueError("fedavg_agg reads the global and the client slab as "
                         "they lie: pass contiguous tensors")
    g = global_flat.reshape(-1, global_flat.shape[-1])
    b, p = g.shape
    n = client_flat.shape[-2]
    if b > _MAX_BATCH:
        raise ValueError(f"fedavg_agg: B={b} above {_MAX_BATCH} scenarios "
                         f"per launch")
    m = mask.to(torch.float32).contiguous()
    out = torch.empty_like(g)
    if b > 0 and p > 0:
        lib = _library()
        with torch.cuda.device(g.device):
            stream = torch.cuda.current_stream(g.device).cuda_stream
            err = lib.fedavg_agg(g.data_ptr(), client_flat.data_ptr(),
                                 m.data_ptr(), out.data_ptr(), b, n, p,
                                 DTYPES[g.dtype], stream)
        if err != 0:
            raise RuntimeError(f"fedavg_agg launch failed: "
                               f"{lib.fedavg_agg_error_string(err).decode()}")
        counts.launches += 1
    return out.reshape(global_flat.shape)
