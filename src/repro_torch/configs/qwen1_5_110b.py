"""qwen1.5-110b — QKV bias [hf:Qwen/Qwen1.5-0.5B; hf].

80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064.
"""
from repro_torch.configs.base import ArchConfig, ATTN, MLP

CONFIG = ArchConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49_152,
    vocab_size=152_064,
    block_pattern=((ATTN, MLP),),
    qkv_bias=True,
    rope_theta=1_000_000.0,
    fsdp=True,
    grad_accum=8,
    opt_moment_dtype="bfloat16",
    param_dtype="bfloat16",
    seq_shard_activations=True,
    kv_cache_dtype="int8",
)

REDUCED = ArchConfig(
    name="qwen-reduced",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_ff=384,
    vocab_size=512,
    block_pattern=((ATTN, MLP),),
    qkv_bias=True,
)
