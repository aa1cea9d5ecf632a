"""Batched Poisson-Binomial kernel (paper eq. (9) + leave-one-out), CUDA.

Port of the Pallas TPU kernel ``src/repro/kernels/poibin_dft.py:poibin_dft``
as the hand-written CUDA C++ kernel ``csrc/poibin_dft.cu`` (``sm_90a``,
bound with ``ctypes``; the source note there gives its design and bound).
One launch computes, for a (B, N) probability matrix, the DFT pmf
(B, N+1) and — with ``with_loo`` — all N leave-one-out pmfs (B, N, N+1).

dtype policy, as in the reference: the input is cast to fp32 here, all
kernel arithmetic is fp32, and the outputs are cast back to the input
dtype. For a tensor on the CPU the wrapper runs the plain version
(:func:`repro_torch.kernels.ref.poibin_dft_ref` in fp32); for a CUDA
tensor it launches the kernel or raises. :data:`counts` records both.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from repro_torch.kernels import build, ref

__all__ = ["MAX_SMEM_BYTES", "counts", "reset_counts", "dft_tables",
           "poibin_dft"]

#: Shared memory one block may use on Hopper (227 KB).
MAX_SMEM_BYTES = 232_448


@dataclasses.dataclass
class _Counts:
    launches: int = 0   # kernel launches on a CUDA tensor
    plain: int = 0      # calls served by the plain version (CPU tensors)


counts = _Counts()
_tables: dict[tuple[int, str], tuple[torch.Tensor, torch.Tensor]] = {}
_lib: ctypes.CDLL | None = None


def reset_counts() -> None:
    """Zero :data:`counts` (start of a measured region)."""
    counts.launches = 0
    counts.plain = 0


def dft_tables(n: int, device: torch.device) -> tuple[torch.Tensor,
                                                      torch.Tensor]:
    """(S, S) fp32 cos/sin DFT matrices, cached per (N, device).

    Built as the reference builds them: the angle ``2π·outer(idx, idx)/S``
    in float64, then cos/sin cast to float32.
    """
    key = (n, str(device))
    if key not in _tables:
        size = n + 1
        idx = torch.arange(size, dtype=torch.float64)
        ang = 2.0 * math.pi * torch.outer(idx, idx) / size
        _tables[key] = (torch.cos(ang).to(torch.float32).to(device),
                        torch.sin(ang).to(torch.float32).to(device))
    return _tables[key]


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("poibin_dft")
        lib.poibin_dft_f32.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.poibin_dft_f32.restype = ctypes.c_int
        lib.poibin_dft_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.poibin_dft_smem_bytes.restype = ctypes.c_size_t
        lib.poibin_dft_error_string.argtypes = [ctypes.c_int]
        lib.poibin_dft_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def poibin_dft(p_mat: torch.Tensor, *, with_loo: bool = True):
    """p_mat: (B, N) -> pmf (B, N+1) [, loo (B, N, N+1) if ``with_loo``].

    ``loo[b, i]`` is the pmf of scenario b's nodes excluding node i
    (support 0..N-1, last entry zero). Outputs are in ``p_mat.dtype``.
    """
    if p_mat.dim() != 2 or p_mat.shape[1] < 1:
        raise ValueError(f"p_mat must be (B, N) with N >= 1, got "
                         f"{tuple(p_mat.shape)}")
    if not p_mat.is_floating_point():
        raise TypeError(f"p_mat must be floating point, got {p_mat.dtype}")
    if p_mat.device.type == "cpu":
        counts.plain += 1
        out = ref.poibin_dft_ref(p_mat.to(torch.float32), with_loo=with_loo)
        if not with_loo:
            return out.to(p_mat.dtype)
        return out[0].to(p_mat.dtype), out[1].to(p_mat.dtype)
    if p_mat.device.type != "cuda":
        raise ValueError(f"poibin_dft runs on CUDA or CPU tensors, got "
                         f"{p_mat.device}")
    b, n = p_mat.shape
    lib = _library()
    smem = lib.poibin_dft_smem_bytes(n, int(with_loo))
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"poibin_dft: N={n} needs {smem} bytes of shared "
                         f"memory per block, above {MAX_SMEM_BYTES}")
    p32 = p_mat.to(torch.float32).contiguous()
    cos, sin = dft_tables(n, p_mat.device)
    pmf = torch.empty((b, n + 1), dtype=torch.float32, device=p_mat.device)
    loo = (torch.empty((b, n, n + 1), dtype=torch.float32,
                       device=p_mat.device) if with_loo else None)
    if b > 0:
        with torch.cuda.device(p_mat.device):
            stream = torch.cuda.current_stream(p_mat.device).cuda_stream
            err = lib.poibin_dft_f32(
                p32.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                pmf.data_ptr(), None if loo is None else loo.data_ptr(),
                b, n, stream)
        if err != 0:
            raise RuntimeError(f"poibin_dft launch failed: "
                               f"{lib.poibin_dft_error_string(err).decode()}")
        counts.launches += 1
    if not with_loo:
        return pmf.to(p_mat.dtype)
    return pmf.to(p_mat.dtype), loo.to(p_mat.dtype)
