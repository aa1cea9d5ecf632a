"""ResNet-18 on CIFAR-class images — the paper's federated workload.

The paper's Table I trains ResNet-18 (w = 11,181,642 params, S_w = 44.73 MB
fp32) federated over 50 IoT nodes. Mapping onto :class:`ModelConfig`:
``d_model`` is the stem width (stages are x1/x2/x4/x8 multiples) and
``vocab`` is the class count; attention/FFN fields are unused
(``attn="none"``, ``d_ff=0``). ``reduced()`` shrinks the width to 8
(~0.2M params) for CPU campaign smoke tests.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="resnet18-cifar",
    family="vision",
    n_layers=18,            # fixed ResNet-18 topology (4 stages x 2 blocks)
    d_model=64,             # stem width (paper: 11.18M params at 64)
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=10,               # CIFAR-10 classes
    source="He et al. 2015; paper Table I (w=11,181,642, S_w=44.73 MB)",
    attn="none",
    param_dtype="float32",
    compute_dtype="float32",
)
