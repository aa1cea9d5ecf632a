"""Architecture configs. ``get_config(name)`` resolves --arch ids.

A copy of :mod:`repro.configs` (data only, no JAX): the port keeps its own
so that it never imports the reference package."""
from __future__ import annotations

from repro_torch.configs.base import INPUT_SHAPES, ModelConfig, ShapeSpec

from repro_torch.configs.stablelm_3b import CONFIG as STABLELM_3B
from repro_torch.configs.internvl2_26b import CONFIG as INTERNVL2_26B
from repro_torch.configs.minicpm3_4b import CONFIG as MINICPM3_4B
from repro_torch.configs.whisper_tiny import CONFIG as WHISPER_TINY
from repro_torch.configs.phi4_mini_3_8b import CONFIG as PHI4_MINI_3_8B
from repro_torch.configs.olmoe_1b_7b import CONFIG as OLMOE_1B_7B
from repro_torch.configs.hymba_1_5b import CONFIG as HYMBA_1_5B
from repro_torch.configs.rwkv6_3b import CONFIG as RWKV6_3B
from repro_torch.configs.deepseek_v2_236b import CONFIG as DEEPSEEK_V2_236B
from repro_torch.configs.gemma_2b import CONFIG as GEMMA_2B
from repro_torch.configs.resnet18_cifar import CONFIG as RESNET18_CIFAR

ARCHITECTURES: dict[str, ModelConfig] = {
    c.name: c for c in [
        STABLELM_3B, INTERNVL2_26B, MINICPM3_4B, WHISPER_TINY,
        PHI4_MINI_3_8B, OLMOE_1B_7B, HYMBA_1_5B, RWKV6_3B,
        DEEPSEEK_V2_236B, GEMMA_2B, RESNET18_CIFAR,
    ]
}

# (arch, shape) pairs excluded from the 10x4 grid, with reasons (DESIGN.md §4).
SKIPS: dict[tuple[str, str], str] = {
    ("whisper-tiny", "long_500k"):
        "encoder-decoder ASR with bounded (30 s) audio context; a 512k-token "
        "autoregressive decode is not meaningful",
    ("resnet18-cifar", "prefill_32k"):
        "image classifier: no token sequence, no prefill/decode paths",
    ("resnet18-cifar", "decode_32k"):
        "image classifier: no token sequence, no prefill/decode paths",
    ("resnet18-cifar", "long_500k"):
        "image classifier: no token sequence, no prefill/decode paths",
}


def get_config(name: str) -> ModelConfig:
    try:
        return ARCHITECTURES[name]
    except KeyError:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(ARCHITECTURES)}"
        ) from None


def grid() -> list[tuple[ModelConfig, ShapeSpec]]:
    """The assigned 10 x 4 grid minus documented skips."""
    out = []
    for arch in ARCHITECTURES.values():
        for shape in INPUT_SHAPES.values():
            if (arch.name, shape.name) not in SKIPS:
                out.append((arch, shape))
    return out
