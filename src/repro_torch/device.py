"""Resolution of the ``device=`` argument every entry point takes."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "as_float64", "as_tensor"]


def resolve_device(device: str | torch.device) -> torch.device:
    """The ``torch.device`` an entry point runs on.

    Entry points default to ``"cuda"``. Asking for CUDA on a machine
    without it raises: the port never falls back to the CPU unless the
    caller passes ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(dev)!r} asked for but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    return dev


def as_float64(x, device: torch.device) -> torch.Tensor:
    """``x`` (a tensor, array, list or scalar) as a float64 tensor on
    ``device``. A non-tensor is copied, so a read-only numpy array handed
    in (a JAX result, say) is never aliased."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float64)
    return torch.tensor(x, dtype=torch.float64, device=device)


def as_tensor(x, device: torch.device) -> torch.Tensor:
    """``x`` on ``device`` in its own dtype; a non-tensor goes through
    ``numpy.array`` (copied), so Python floats become float64, as under
    the reference's x64."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.array(x)).to(device)
