"""Fused cross-entropy kernel (hidden @ vocab → per-token NLL, the logits
never stored), batched over replicas, CUDA.

Port of the Pallas TPU kernel ``src/repro/kernels/fused_ce.py:fused_ce`` as
the hand-written CUDA C++ kernel ``csrc/fused_ce.cu`` (``sm_90a``, bound
with ``ctypes``; the source note there gives its design and bound). Every
FL client holds its own ``lm_head``, so the kernel takes a leading replica
axis on all three inputs: ``hidden (R, T, d)``, ``w (R, d, V)``, ``labels
(R, T)`` → ``(R, T)`` fp32 NLL; unbatched ``(T, d)``, ``(d, V)``, ``(T,)``
inputs are one replica.

dtype policy, as in the reference: fp32 accumulation and logsumexp, fp32
output; fp32 and bf16 inputs. For tensors on the CPU the wrapper runs the
plain version (:func:`repro_torch.kernels.ref.fused_ce_ref`); for CUDA
tensors it launches the kernel or raises. :data:`counts` records both.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import build, ref

__all__ = ["DTYPES", "counts", "reset_counts", "fused_ce"]

#: dtypes the kernel reads, with their code in the C interface.
DTYPES = {torch.float32: 0, torch.bfloat16: 2}
_MAX_REPLICAS = 65_535      # the grid's y dimension


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
        lib = build.load("fused_ce")
        lib.fused_ce.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
        lib.fused_ce.restype = ctypes.c_int
        lib.fused_ce_error_string.argtypes = [ctypes.c_int]
        lib.fused_ce_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(hidden: torch.Tensor, w: torch.Tensor,
           labels: torch.Tensor) -> None:
    if hidden.dim() not in (2, 3) or w.dim() != hidden.dim() or \
            labels.dim() != hidden.dim() - 1:
        raise ValueError(f"expected hidden (T, d), w (d, V), labels (T,) "
                         f"with an optional leading replica axis, got "
                         f"{tuple(hidden.shape)}, {tuple(w.shape)}, "
                         f"{tuple(labels.shape)}")
    lead, (t, d) = tuple(hidden.shape[:-2]), hidden.shape[-2:]
    if tuple(w.shape[:-2]) != lead or w.shape[-2] != d or \
            tuple(labels.shape) != lead + (t,):
        raise ValueError(f"w {tuple(w.shape)} or labels "
                         f"{tuple(labels.shape)} do not match hidden "
                         f"{tuple(hidden.shape)}")
    if hidden.dtype not in DTYPES or w.dtype != hidden.dtype:
        raise TypeError(f"hidden and w must share one of {list(DTYPES)}, "
                        f"got {hidden.dtype} and {w.dtype}")
    if labels.dtype.is_floating_point or labels.dtype == torch.bool:
        raise TypeError(f"labels must be integers, got {labels.dtype}")
    devices = {hidden.device, w.device, labels.device}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")


def _rows_contiguous(x: torch.Tensor) -> torch.Tensor:
    """``x`` (R, rows, cols) with rows contiguous, keeping a replica stride
    where it can (a replica's block of a flat parameter slab is read where
    it lies)."""
    if x.stride(2) == 1 and x.stride(1) == x.shape[2]:
        return x
    return x.contiguous()


def fused_ce(hidden: torch.Tensor, w: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
    """Per-token NLL ``logsumexp_v(h·W_v) − h·W_label`` without the logits.

    Args:
        hidden: ``(T, d)`` or ``(R, T, d)`` final hidden states.
        w: ``(d, V)`` or ``(R, d, V)`` vocabulary projection, in hidden's
            dtype.
        labels: ``(T,)`` or ``(R, T)`` integer targets in ``[0, V)``.

    Returns:
        ``(T,)`` or ``(R, T)`` float32 NLL.
    """
    _check(hidden, w, labels)
    if hidden.device.type == "cpu":
        counts.plain += 1
        return ref.fused_ce_ref(hidden, w, labels)
    if hidden.device.type != "cuda":
        raise ValueError(f"fused_ce runs on CUDA or CPU tensors, got "
                         f"{hidden.device}")
    batched = hidden.dim() == 3
    h3 = hidden if batched else hidden[None]
    w3 = w if batched else w[None]
    lab = (labels if batched else labels[None]).to(torch.int32).contiguous()
    r, t, d = h3.shape
    vocab = w3.shape[-1]
    if r > _MAX_REPLICAS:
        raise ValueError(f"fused_ce: R={r} above {_MAX_REPLICAS} replicas "
                         f"per launch")
    h3, w3 = _rows_contiguous(h3), _rows_contiguous(w3)
    out = torch.empty((r, t), dtype=torch.float32, device=hidden.device)
    if r > 0 and t > 0 and d > 0 and vocab > 0:
        lib = _library()
        with torch.cuda.device(hidden.device):
            stream = torch.cuda.current_stream(hidden.device).cuda_stream
            err = lib.fused_ce(h3.data_ptr(), w3.data_ptr(), lab.data_ptr(),
                               out.data_ptr(), r, t, d, vocab, h3.stride(0),
                               w3.stride(0), DTYPES[hidden.dtype], stream)
        if err != 0:
            raise RuntimeError(f"fused_ce launch failed: "
                               f"{lib.fused_ce_error_string(err).decode()}")
        counts.launches += 1
    return out if batched else out[0]
