"""jamba-1.5-large-398b — Mamba+attn 1:7 interleave, MoE [arXiv:2403.19887; hf].

72L d_model=8192 64H (GQA kv=8) d_ff=24576, MoE 16e top-2.
Published Jamba block: 8 sublayers, attention at position 4 (1:7 ratio),
MoE replaces the MLP every 2nd sublayer -> 9 blocks x 8 = 72 layers,
9 attention / 63 mamba, 36 MoE / 36 dense FFN.
Analytic total ~398B params, ~94B active (matches the model card).
Sub-quadratic (hybrid). One block holds ~90 GB of bf16 weights, more
than one card: the port serves a prefix of the block pattern
(``dataclasses.replace(CONFIG, n_layers=k, block_pattern=
CONFIG.block_pattern[:k])``).
"""
from repro_torch.configs.base import ArchConfig, ATTN, MAMBA, MLP, MOE

_BLOCK = (
    (MAMBA, MLP),
    (MAMBA, MOE),
    (MAMBA, MLP),
    (MAMBA, MOE),
    (ATTN, MLP),
    (MAMBA, MOE),
    (MAMBA, MLP),
    (MAMBA, MOE),
)

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24_576,
    vocab_size=65_536,
    block_pattern=_BLOCK,
    n_experts=16,
    top_k=2,
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
    rope_theta=0.0,  # Jamba uses no positional encoding in attention
    fsdp=True,
    grad_accum=16,  # micro-batch 16 == |data| so batch still shards dp
    opt_moment_dtype="bfloat16",
    param_dtype="bfloat16",
    grad_dtype="bfloat16",
    seq_shard_activations=True,
)

REDUCED = ArchConfig(
    name="jamba-reduced",
    family="hybrid",
    n_layers=8,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    block_pattern=_BLOCK,
    n_experts=4,
    top_k=2,
    mamba_d_state=8,
    mamba_d_conv=4,
    mamba_expand=2,
    rope_theta=0.0,
)
