"""Carry the reference's state across into the port.

The reference's objects hold JAX arrays; the port never imports JAX, so a
caller (a parity test, a migration script) hands their fields across as
numpy arrays and Python scalars, e.g.
``{f: np.asarray(getattr(model, f)) for f in DURATION_FIELDS}``.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.core.controller import ParticipationController
from repro_torch.core.duration import DurationModel

__all__ = ["DURATION_FIELDS", "CONTROLLER_FIELDS",
           "duration_model_from_numpy", "controller_from_numpy"]

DURATION_FIELDS = ("coeffs", "n_nodes", "d_zero", "d_floor", "lo_frac",
                   "hi_frac", "rise")
#: The controller's scalar fields that the port carries.
CONTROLLER_FIELDS = ("n_nodes", "gamma", "cost", "mode", "fixed_p",
                     "target_poa")


def _require(fields: Mapping[str, Any], names: tuple[str, ...]) -> None:
    missing = sorted(set(names) - set(fields))
    if missing:
        raise KeyError(f"missing fields {missing}")


def duration_model_from_numpy(fields: Mapping[str, Any]) -> DurationModel:
    """The port's :class:`DurationModel` from the reference model's fields
    (``coeffs`` as an array, the rest as scalars)."""
    _require(fields, DURATION_FIELDS)
    return DurationModel(
        coeffs=torch.tensor(np.asarray(fields["coeffs"], np.float64)),
        n_nodes=int(fields["n_nodes"]),
        d_zero=float(fields["d_zero"]),
        d_floor=float(fields["d_floor"]),
        lo_frac=float(fields["lo_frac"]),
        hi_frac=float(fields["hi_frac"]),
        rise=float(fields["rise"]))


def controller_from_numpy(fields: Mapping[str, Any],
                          duration_fields: Mapping[str, Any] | None = None,
                          *, device: str | torch.device = "cuda"
                          ) -> ParticipationController:
    """The port's controller from the reference controller's scalar fields
    (:data:`CONTROLLER_FIELDS`) and, optionally, its duration model's
    fields (``None`` builds the port's own paper model)."""
    _require(fields, CONTROLLER_FIELDS)
    dur = (None if duration_fields is None
           else duration_model_from_numpy(duration_fields))
    return ParticipationController(
        n_nodes=int(fields["n_nodes"]),
        gamma=float(fields["gamma"]),
        cost=float(fields["cost"]),
        mode=str(fields["mode"]),
        fixed_p=float(fields["fixed_p"]),
        target_poa=float(fields["target_poa"]),
        duration_model=dur,
        device=device)
