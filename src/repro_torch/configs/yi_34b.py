"""yi-34b — llama-arch GQA [arXiv:2403.04652; hf].

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000. head_dim=128.
56 heads do not divide the 16-way model axis -> adaptive attention
partitioning falls back to sequence/context parallelism (see DESIGN.md §4).
"""
from repro_torch.configs.base import ArchConfig, ATTN, MLP

CONFIG = ArchConfig(
    name="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20_480,
    vocab_size=64_000,
    head_dim=128,
    block_pattern=((ATTN, MLP),),
    rope_theta=5_000_000.0,
    fsdp=True,
    param_dtype="bfloat16",
    seq_shard_activations=True,
    grad_accum=2,
    kv_cache_dtype="int8",
)

REDUCED = ArchConfig(
    name="yi-reduced",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    head_dim=32,
    block_pattern=((ATTN, MLP),),
)
