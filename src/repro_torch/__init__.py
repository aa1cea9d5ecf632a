"""PyTorch/CUDA port of :mod:`repro`, module by module.

The package mirrors ``repro``'s layout (``repro_torch.core.poibin`` ↔
``repro.core.poibin``) and imports ``torch`` only. The game layer runs in
``torch.float64`` passed explicitly; kernels follow the fp32-accumulate,
output-in-input-dtype policy of the reference. Entry points take
``device=`` (default ``"cuda"``) and raise when CUDA is asked for and
absent — see :mod:`repro_torch.device`.
"""
