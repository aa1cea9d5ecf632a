"""Model/run configuration schema.

Every assigned architecture is a :class:`ModelConfig`; every assigned input
shape is a :class:`ShapeSpec`. ``reduced()`` produces the CPU smoke-test
variant (≤2 layers, d_model ≤ 512, ≤4 experts) of the same family.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional

__all__ = ["ModelConfig", "ShapeSpec", "INPUT_SHAPES", "MLAConfig", "MoEConfig",
           "SSMConfig"]

Family = Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio", "vision"]
AttnKind = Literal["gqa", "mla", "none"]


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3)."""

    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Top-k routed experts with optional always-on shared experts."""

    n_experts: int = 8
    top_k: int = 2
    n_shared: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # layers before the first MoE layer use a dense MLP of this width
    first_dense_layers: int = 0
    dense_ff: int = 0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """State-space / linear-recurrence head config (Mamba-style or RWKV)."""

    state_dim: int = 16
    head_dim: int = 64          # rwkv wkv head size / mamba head grouping
    expand: int = 1             # d_inner = expand * d_model (mamba branch)
    dt_rank: int = 0            # 0 -> ceil(d_model/16)
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int                 # 0 for attention-free archs
    n_kv_heads: int
    d_ff: int
    vocab: int
    source: str = ""             # paper/model-card citation
    attn: AttnKind = "gqa"
    head_dim: int = 0            # 0 -> d_model // n_heads
    act: Literal["swiglu", "geglu", "gelu"] = "swiglu"
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    sliding_window: int = 0      # 0 = full causal; >0 enables long_500k decode
    # -- modality frontends (stubs; see DESIGN.md) --------------------------
    n_patches: int = 0           # vlm: image patch tokens per example
    d_frontend: int = 0          # vlm: vision encoder output dim (projector in)
    n_frames: int = 0            # audio: encoder frames per example
    encoder_layers: int = 0      # audio: encoder depth (enc-dec)
    # -- numerics ------------------------------------------------------------
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    logit_dtype: str = "float32"

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.n_heads:
            return self.d_model // self.n_heads
        return 64

    @property
    def is_encoder_decoder(self) -> bool:
        return self.family == "audio"

    def reduced(self) -> "ModelConfig":
        """CPU smoke-test variant of the same family (system-prompt bounds)."""
        changes: dict = dict(
            name=self.name + "-reduced",
            n_layers=min(self.n_layers, 2),
            d_model=min(self.d_model, 256),
            vocab=min(self.vocab, 512),
            param_dtype="float32",
            compute_dtype="float32",
        )
        if self.family == "vision":
            # d_model is the convnet stem width; 8 keeps the reduced
            # ResNet-18 at ~0.2M params for CPU campaign smoke tests.
            changes["d_model"] = min(self.d_model, 8)
        if self.n_heads:
            n_heads = min(self.n_heads, 4)
            changes["n_heads"] = n_heads
            ratio = max(1, self.n_heads // max(self.n_kv_heads, 1))
            changes["n_kv_heads"] = max(1, n_heads // min(ratio, n_heads))
            changes["head_dim"] = changes["d_model"] // n_heads
        else:
            changes["n_heads"] = 0
            changes["n_kv_heads"] = 0
            changes["head_dim"] = 32
        changes["d_ff"] = min(self.d_ff, 512)
        if self.mla is not None:
            changes["mla"] = MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                                       qk_nope_head_dim=16, qk_rope_head_dim=8,
                                       v_head_dim=16)
        if self.moe is not None:
            changes["moe"] = dataclasses.replace(
                self.moe, n_experts=min(self.moe.n_experts, 4),
                top_k=min(self.moe.top_k, 2),
                n_shared=min(self.moe.n_shared, 1),
                first_dense_layers=min(self.moe.first_dense_layers, 1),
                dense_ff=min(self.moe.dense_ff, 512))
        if self.ssm is not None:
            changes["ssm"] = dataclasses.replace(
                self.ssm, state_dim=min(self.ssm.state_dim, 8), head_dim=32)
        if self.sliding_window:
            changes["sliding_window"] = min(self.sliding_window, 64)
        if self.n_patches:
            changes["n_patches"] = 16
            changes["d_frontend"] = 64
        if self.n_frames:
            changes["n_frames"] = 32
        if self.encoder_layers:
            changes["encoder_layers"] = min(self.encoder_layers, 2)
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """An assigned (seq_len, global_batch) workload."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


INPUT_SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}
