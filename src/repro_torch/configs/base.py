"""Architecture configurations (port of ``repro.configs.base``).

``ArchConfig`` is copied as data, field for field, so that a
configuration reads the same in both packages; every arch of the
reference has its module here. The analytic parameter counts
(``param_count``, ``active_param_count``) and the workload shapes
(``SHAPES``, ``cell_applicable``) are the reference's arithmetic and
data, copied; ``repro_torch.launch.dryrun`` runs them.
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

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS and sanity
        tests)."""
        return _param_count(self)

    def active_param_count(self) -> int:
        return _param_count(self, active_only=True)


def _ffn_params(cfg: ArchConfig, kind: str, active_only: bool) -> int:
    if kind == NOFF:
        return 0
    if kind == MOE:
        per_expert = 3 * cfg.d_model * cfg.d_ff  # gate, up, down (swiglu)
        router = cfg.d_model * cfg.n_experts
        n_e = cfg.top_k if active_only else cfg.n_experts
        return n_e * per_expert + router
    mult = 3 if cfg.act == "swiglu" else 2
    return mult * cfg.d_model * cfg.d_ff


def _mixer_params(cfg: ArchConfig, kind: str) -> int:
    d, hd = cfg.d_model, cfg.hd
    if kind in (ATTN, XATTN):
        q = d * cfg.n_heads * hd
        kv = 2 * d * cfg.n_kv_heads * hd
        o = cfg.n_heads * hd * d
        b = (cfg.n_heads * hd + 2 * cfg.n_kv_heads * hd) if cfg.qkv_bias \
            else 0
        return q + kv + o + b
    if kind == MAMBA:
        din, n, dtr = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.dt_rank
        return (
            d * 2 * din  # in_proj
            + din * cfg.mamba_d_conv  # depthwise conv
            + din * (dtr + 2 * n)  # x_proj
            + dtr * din  # dt_proj
            + din * n  # A_log
            + din  # D
            + din * d  # out_proj
        )
    if kind == RWKV:
        lora = d * cfg.rwkv_decay_lora * 2 + d * cfg.rwkv_gate_lora * 2
        # time-mix: W_r, W_k, W_v, W_g, W_o (5 square) + decay lora + mus + u
        tm = 5 * d * d + lora + 7 * d
        cm = d * cfg.d_ff + cfg.d_ff * d + d * d + 2 * d  # channel mix
        return tm + cm
    raise ValueError(kind)


def _param_count(cfg: ArchConfig, active_only: bool = False) -> int:
    per_block = 0
    for mixer, ffn in cfg.block_pattern:
        per_block += _mixer_params(cfg, mixer)
        per_block += _ffn_params(cfg, ffn, active_only)
        per_block += 2 * cfg.d_model  # two norms per sublayer (pre-norm)
    total = cfg.n_blocks * per_block
    stacks = 2 if cfg.enc_dec else 1
    total *= stacks
    if cfg.enc_dec:  # decoder cross-attention over encoder output
        total += cfg.n_layers * (_mixer_params(cfg, ATTN) + cfg.d_model)
    total += cfg.vocab_size * cfg.d_model  # embedding
    if not cfg.tie_embeddings:
        total += cfg.vocab_size * cfg.d_model  # lm head
    total += cfg.d_model  # final norm
    return total


# ---------------------------------------------------------------------------
# Workload shapes (the assignment's per-arch input-shape set).
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def cell_applicable(cfg: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Whether an (arch x shape) cell runs, with the reason when
    skipped."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, (
            "long_500k needs sub-quadratic sequence mixing; "
            f"{cfg.name} is pure full-attention (skip per brief, see "
            "DESIGN.md)"
        )
    return True, ""


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


def _module(arch: str):
    arch = PUBLIC_IDS.get(arch, arch)
    if arch not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str) -> ArchConfig:
    return _module(arch).CONFIG


def get_reduced_config(arch: str) -> ArchConfig:
    return _module(arch).REDUCED


def all_arch_ids() -> list:
    return list(ARCH_IDS)
