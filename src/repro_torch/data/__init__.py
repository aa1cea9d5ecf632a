"""Deterministic synthetic datasets of the port (:mod:`repro.data`)."""
from repro_torch.data.synthetic import SyntheticCifar, SyntheticLM

__all__ = ["SyntheticCifar", "SyntheticLM"]
