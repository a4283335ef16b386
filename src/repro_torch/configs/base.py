"""Architecture configurations (port of ``repro.configs.base``).

``ArchConfig`` is copied as data, field for field, so that a
configuration reads the same in both packages. Only the archs whose
serving path the port runs load here (:data:`PORTED`); the others raise
``NotImplementedError`` until their slice lands (ROADMAP, module 9). The
reference's workload shapes (``SHAPES``, ``cell_applicable``) wait for
a slice that runs them.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Tuple

# sublayer kinds of a super-block: (mixer, ffn) pairs
ATTN, MAMBA, RWKV, XATTN = "attn", "mamba", "rwkv", "xattn"
MLP, MOE, NOFF = "mlp", "moe", "none"


def round_up(a: int, multiple: int) -> int:
    return -(-a // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # super-block structure
    block_pattern: Tuple[Tuple[str, str], ...] = ((ATTN, MLP),)

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_jitter: float = 0.0

    # RWKV6
    rwkv_head_size: int = 64
    rwkv_decay_lora: int = 64
    rwkv_gate_lora: int = 64

    # Mamba
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_dt_rank: int = 0  # 0 -> ceil(d_model/16)

    # encoder-decoder
    enc_dec: bool = False

    # VLM cross-attention
    cross_attn_every: int = 0
    n_frontend_tokens: int = 0

    qkv_bias: bool = False
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "swiglu"  # swiglu | gelu
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0

    # distribution policy (read by the reference's launchers only)
    fsdp: bool = False
    remat: str = "full"
    grad_accum: int = 1
    opt_moment_dtype: str = "float32"
    param_dtype: str = "float32"
    grad_dtype: str = "float32"
    seq_shard_activations: bool = False

    # serving
    kv_cache_dtype: str = "bfloat16"  # bfloat16 | int8 (blockwise-scaled)

    accmpeg_applicable: bool = False

    # ---- derived ------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return round_up(self.vocab_size, 256)

    @property
    def n_blocks(self) -> int:
        if self.n_layers % len(self.block_pattern):
            raise ValueError(f"{self.name}: {self.n_layers} layers do not "
                             f"tile the block pattern {self.block_pattern}")
        return self.n_layers // len(self.block_pattern)

    @property
    def rwkv_n_heads(self) -> int:
        return self.d_model // self.rwkv_head_size

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.mamba_dt_rank or -(-self.d_model // 16)

    @property
    def attn_free(self) -> bool:
        return all(m not in (ATTN, XATTN) for m, _ in self.block_pattern)

    @property
    def subquadratic(self) -> bool:
        """Eligible for the long_500k cell (SSM / hybrid / linear
        attention)."""
        return self.family in ("ssm", "hybrid")


ARCH_IDS = [
    "rwkv6_1b6",
    "olmoe_1b_7b",
    "moonshot_v1_16b_a3b",
    "yi_34b",
    "smollm_360m",
    "stablelm_3b",
    "qwen1_5_110b",
    "llama3_2_vision_90b",
    "seamless_m4t_large_v2",
    "jamba1_5_large_398b",
]

PUBLIC_IDS = {
    "rwkv6-1.6b": "rwkv6_1b6",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "yi-34b": "yi_34b",
    "smollm-360m": "smollm_360m",
    "stablelm-3b": "stablelm_3b",
    "qwen1.5-110b": "qwen1_5_110b",
    "llama-3.2-vision-90b": "llama3_2_vision_90b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "jamba-1.5-large-398b": "jamba1_5_large_398b",
}

#: the archs whose configuration module the port carries
PORTED = ("smollm_360m", "rwkv6_1b6", "stablelm_3b", "olmoe_1b_7b",
          "moonshot_v1_16b_a3b", "llama3_2_vision_90b",
          "jamba1_5_large_398b", "seamless_m4t_large_v2")


def _module(arch: str):
    arch = PUBLIC_IDS.get(arch, arch)
    if arch not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    if arch not in PORTED:
        raise NotImplementedError(
            f"{arch} is not ported yet; the port carries {PORTED} "
            f"(ROADMAP, module 9, queues the rest)")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str) -> ArchConfig:
    return _module(arch).CONFIG


def get_reduced_config(arch: str) -> ArchConfig:
    return _module(arch).REDUCED
