"""Model configuration for the PyTorch port.

A copy of the dataclasses in the JAX package's ``configs/base.py`` (the port
imports nothing of that package).  The fields are identical, so a config
module copies over unchanged; the registry lists the JAX package's ten
architectures in its order.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

__all__ = [
    "MoEConfig",
    "SSMConfig",
    "MLAConfig",
    "FrontendConfig",
    "ModelConfig",
    "ARCH_IDS",
    "get_config",
]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert_ff: int
    layer_period: int = 1  # MoE on layers where i % period == offset
    layer_offset: int = 0
    capacity_factor: float = 1.25
    router_jitter: bool = False
    hierarchical_a2a: bool = True
    valiant_shuffle: bool = False


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128
    conv_width: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    kind: str  # "vision" | "audio"
    d_frontend: int
    n_tokens: int


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0  # 0 -> d_model // n_heads
    attn_type: str = "full"  # full | swa | mla
    sliding_window: int = 0  # for swa
    qk_norm: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    mla: Optional[MLAConfig] = None
    # hybrid interleave: layer i is attention iff i % attn_period == attn_offset
    attn_period: int = 1
    attn_offset: int = 0
    enc_dec: bool = False
    n_encoder_layers: int = 0
    frontend: Optional[FrontendConfig] = None
    rope_theta: float = 10000.0
    use_rope: bool = True
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # the next four steer the JAX package's compiler and mesh; the port
    # keeps them so that config modules copy over unchanged
    remat: bool = True
    scan_layers: bool = True
    sequence_parallel: bool = True
    max_seq_len: int = 524288

    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // self.n_heads if self.n_heads else 0

    def layer_is_attention(self, i: int) -> bool:
        if self.attn_period == 0:
            return False
        return i % self.attn_period == self.attn_offset

    def layer_is_moe(self, i: int) -> bool:
        if self.moe is None:
            return False
        return i % self.moe.layer_period == self.moe.layer_offset

    def pattern_period(self) -> int:
        """Smallest period of the (mixer, ffn) layer pattern."""
        period = 1
        for p in range(1, self.n_layers + 1):
            if self.n_layers % p:
                continue
            ok = all(
                self.layer_is_attention(i) == self.layer_is_attention(i % p)
                and self.layer_is_moe(i) == self.layer_is_moe(i % p)
                for i in range(self.n_layers)
            )
            if ok:
                period = p
                break
        return period


_MODULES = {
    "jamba-v0.1-52b": "jamba_v01_52b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "minicpm3-4b": "minicpm3_4b",
    "internlm2-1.8b": "internlm2_1_8b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "qwen3-32b": "qwen3_32b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "mamba2-1.3b": "mamba2_1_3b",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
}

ARCH_IDS = list(_MODULES)


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port runs {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.REDUCED if reduced else mod.CONFIG
