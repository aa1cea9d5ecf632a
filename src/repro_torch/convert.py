"""Carry the reference's state across into the port.

The reference's objects hold JAX arrays; the port never imports JAX, so a
caller (a parity test, a migration script) hands their fields across as
numpy arrays and Python scalars, e.g.
``{f: np.asarray(getattr(model, f)) for f in DURATION_FIELDS}``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.configs.base import (MLAConfig, ModelConfig, MoEConfig,
                                      SSMConfig)
from repro_torch.core.comm80211ax import CommParams
from repro_torch.core.controller import ParticipationController
from repro_torch.core.duration import DurationModel
from repro_torch.core.energy import EnergyParams
from repro_torch.device import resolve_device
from repro_torch.federated.simulation import FLConfig

__all__ = ["DURATION_FIELDS", "CONTROLLER_FIELDS", "COMM_FIELDS",
           "ENERGY_FIELDS", "FL_CONFIG_FIELDS", "duration_model_from_numpy",
           "controller_from_numpy", "comm_params_from_numpy",
           "energy_params_from_numpy", "fl_config_from_numpy",
           "params_from_numpy", "MODEL_CONFIG_FIELDS",
           "model_config_from_numpy", "model_params_from_numpy"]

DURATION_FIELDS = ("coeffs", "n_nodes", "d_zero", "d_floor", "lo_frac",
                   "hi_frac", "rise")
#: The controller's scalar fields that the port carries.
CONTROLLER_FIELDS = ("n_nodes", "gamma", "cost", "mode", "fixed_p",
                     "target_poa")
COMM_FIELDS = tuple(f.name for f in dataclasses.fields(CommParams))
#: :class:`EnergyParams`' scalar fields; its ``comm`` goes by COMM_FIELDS.
ENERGY_FIELDS = tuple(f.name for f in dataclasses.fields(EnergyParams)
                      if f.name != "comm")
FL_CONFIG_FIELDS = tuple(f.name for f in dataclasses.fields(FLConfig))
MODEL_CONFIG_FIELDS = tuple(f.name for f in dataclasses.fields(ModelConfig))
_SUB_CONFIGS = {"mla": MLAConfig, "moe": MoEConfig, "ssm": SSMConfig}


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


def _scalars(fields: Mapping[str, Any], cls, names: tuple[str, ...]) -> dict:
    """``fields[names]`` as Python scalars of ``cls``'s annotated types."""
    out = {}
    for f in dataclasses.fields(cls):
        if f.name in names:
            v = fields[f.name]
            out[f.name] = int(v) if f.type in (int, "int") else float(v)
    return out


def comm_params_from_numpy(fields: Mapping[str, Any]) -> CommParams:
    """The port's :class:`CommParams` from the reference's fields."""
    _require(fields, COMM_FIELDS)
    return CommParams(**_scalars(fields, CommParams, COMM_FIELDS))


def energy_params_from_numpy(fields: Mapping[str, Any],
                             comm_fields: Mapping[str, Any] | None = None
                             ) -> EnergyParams:
    """The port's :class:`EnergyParams` from the reference's scalar fields
    (:data:`ENERGY_FIELDS`) and, optionally, its ``comm``'s fields."""
    _require(fields, ENERGY_FIELDS)
    comm = {} if comm_fields is None else {
        "comm": comm_params_from_numpy(comm_fields)}
    return EnergyParams(**_scalars(fields, EnergyParams, ENERGY_FIELDS),
                        **comm)


def fl_config_from_numpy(fields: Mapping[str, Any]) -> FLConfig:
    """The port's :class:`FLConfig` from the reference's fields."""
    _require(fields, FL_CONFIG_FIELDS)
    return FLConfig(**_scalars(fields, FLConfig, FL_CONFIG_FIELDS))


def _tensor(x) -> torch.Tensor:
    """A numpy array (bfloat16 ones included, which numpy only knows as an
    extension dtype) as a CPU tensor of the same dtype, copied."""
    arr = np.array(x)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def params_from_numpy(params: Mapping[str, Any], *,
                      device: str | torch.device = "cuda") -> dict:
    """A parameter dict (the reference's flat pytree, leaves as numpy
    arrays) as the port's parameters: tensors on ``device``, each in its
    array's dtype (float64 under the reference's x64), copied."""
    dev = resolve_device(device)
    return {k: _tensor(v).to(dev) for k, v in params.items()}


def model_config_from_numpy(fields: Mapping[str, Any]) -> ModelConfig:
    """The port's :class:`ModelConfig` from a reference ``ModelConfig``'s
    fields (``dataclasses.asdict(cfg)``: the ``mla``/``moe``/``ssm``
    sub-configs as dicts or None)."""
    _require(fields, MODEL_CONFIG_FIELDS)
    kw = {f: fields[f] for f in MODEL_CONFIG_FIELDS}
    for name, cls in _SUB_CONFIGS.items():
        if kw[name] is not None:
            kw[name] = cls(**dict(kw[name]))
    return ModelConfig(**kw)


def model_params_from_numpy(tree: Mapping[str, Any], *,
                            device: str | torch.device = "cuda") -> dict:
    """A reference model's nested parameter tree (``{"embed", "layers":
    {"body": {...}}, "ln_f": {...}, "lm_head"}``, leaves as numpy arrays)
    as the port's flat dict with dotted names (``layers.body.attn.wq``),
    shapes and dtypes kept, on ``device``."""
    flat: dict = {}

    def walk(node: Mapping[str, Any], prefix: str) -> None:
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, f"{prefix}{k}.")
            else:
                flat[f"{prefix}{k}"] = v

    walk(tree, "")
    return params_from_numpy(flat, device=device)


def controller_from_numpy(fields: Mapping[str, Any],
                          duration_fields: Mapping[str, Any] | None = None,
                          *, energy_fields: Mapping[str, Any] | None = None,
                          comm_fields: Mapping[str, Any] | None = None,
                          device: str | torch.device = "cuda"
                          ) -> ParticipationController:
    """The port's controller from the reference controller's scalar fields
    (:data:`CONTROLLER_FIELDS`) and, optionally, its duration model's
    fields (``None`` builds the port's own paper model) and its energy
    parameters' fields (``None`` keeps the defaults)."""
    _require(fields, CONTROLLER_FIELDS)
    dur = (None if duration_fields is None
           else duration_model_from_numpy(duration_fields))
    energy = ({} if energy_fields is None else {
        "energy_params": energy_params_from_numpy(energy_fields,
                                                  comm_fields)})
    return ParticipationController(
        n_nodes=int(fields["n_nodes"]),
        gamma=float(fields["gamma"]),
        cost=float(fields["cost"]),
        mode=str(fields["mode"]),
        fixed_p=float(fields["fixed_p"]),
        target_poa=float(fields["target_poa"]),
        duration_model=dur,
        device=device,
        **energy)
