"""Streaming-softmax (flash) attention kernel, causal / sliding window, GQA,
CUDA.

Port of the Pallas TPU kernel
``src/repro/kernels/flash_attention.py:flash_attention`` as the hand-written
CUDA C++ kernel ``csrc/flash_attention.cu`` (``sm_90a``, bound with
``ctypes``; the source note there gives its design and bound). One launch
covers every batch row: ``q (B, S, H, D)``, ``k``/``v (B, S, KV, D)`` →
``(B, S, H, D)``, with ``H`` a multiple of ``KV`` (query head ``h`` reads kv
head ``h // (H / KV)``) and ``D <= 128``.

dtype policy, as in the reference: fp32 softmax state and accumulation,
output in q's dtype; fp32 and bf16 inputs. For tensors on the CPU the
wrapper runs the plain version (:func:`plain`, the oracle on fp32 copies of
the inputs); for CUDA tensors it launches the kernel or raises.
:data:`counts` records both.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import build, ref

__all__ = ["DTYPES", "MAX_HEAD_DIM", "counts", "reset_counts", "plain",
           "flash_attention"]

#: dtypes the kernel reads, with their code in the C interface.
DTYPES = {torch.float32: 0, torch.bfloat16: 2}
MAX_HEAD_DIM = 128
_MAX_GRID = 65_535          # the grid's y (heads) and z (batch) dimensions


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
        lib = build.load("flash_attention")
        lib.flash_attention.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int,
                                 ctypes.c_void_p]
        lib.flash_attention.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
          causal: bool = True, window: int = 0) -> torch.Tensor:
    """The kernel's plain version: the oracle on fp32 copies of the inputs
    (the kernel's arithmetic), cast to q's dtype."""
    return ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                   causal=causal,
                                   window=window).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"expected q (B, S, H, D) and k, v (B, S, KV, D), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, h, d = q.shape
    kvh = k.shape[2]
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, s, d) or kvh < 1 \
            or h % kvh:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}: expected ({b}, {s}, KV, {d}) "
                         f"with H = {h} a multiple of KV")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one of {list(DTYPES)}, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    devices = {q.device, k.device, v.device}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Causal (optionally sliding-window) GQA attention.

    Args:
        q: ``(B, S, H, D)`` queries.
        k, v: ``(B, S, KV, D)`` keys and values, in q's dtype.
        causal: mask keys after the query.
        window: if > 0, keep only the last ``window`` keys (self included).

    Returns:
        ``(B, S, H, D)`` in q's dtype.
    """
    _check(q, k, v)
    if q.device.type == "cpu":
        counts.plain += 1
        return plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, got "
                         f"{q.device}")
    b, s, h, d = q.shape
    kvh = k.shape[2]
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {d} above "
                         f"{MAX_HEAD_DIM}")
    if b > _MAX_GRID or h > _MAX_GRID:
        raise ValueError(f"flash_attention: B={b} or H={h} above "
                         f"{_MAX_GRID} per launch")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if b > 0 and s > 0:
        lib = _library()
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = lib.flash_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                s, h, kvh, d, int(bool(causal)), int(window), d ** -0.5,
                DTYPES[q.dtype], stream)
        if err != 0:
            raise RuntimeError(
                f"flash_attention launch failed: "
                f"{lib.flash_attention_error_string(err).decode()}")
        counts.launches += 1
    return out
