"""llama-3.2-vision-90b — cross-attn image layers [hf:meta-llama/Llama-3.2-11B-Vision; unverified].

100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
Every 5th sublayer is cross-attention over image tokens (80 self + 20 cross).
The vision frontend is a STUB per the brief: input_specs() provides
precomputed patch embeddings (4 tiles x 1601 patches = 6404 tokens).
AccMPEG-applicable: the patch-embedding stream is the lossily-encoded
sensor input; AccGrad over it drives RoI encoding (DESIGN.md §3).
"""
from repro_torch.configs.base import ArchConfig, ATTN, XATTN, MLP

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28_672,
    vocab_size=128_256,
    block_pattern=((ATTN, MLP),) * 4 + ((XATTN, MLP),),
    cross_attn_every=5,
    n_frontend_tokens=6404,
    rope_theta=500_000.0,
    fsdp=True,
    grad_accum=8,
    opt_moment_dtype="bfloat16",
    param_dtype="bfloat16",
    seq_shard_activations=True,
    kv_cache_dtype="int8",
    accmpeg_applicable=True,
)

REDUCED = ArchConfig(
    name="llama-vision-reduced",
    family="vlm",
    n_layers=5,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    block_pattern=((ATTN, MLP),) * 4 + ((XATTN, MLP),),
    cross_attn_every=5,
    n_frontend_tokens=32,
    accmpeg_applicable=True,
)
