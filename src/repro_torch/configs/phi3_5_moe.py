"""phi3.5-moe-42b-a6.6b — MoE 16e top-2
[hf:microsoft/Phi-3.5-MoE-instruct].

32L d_model=4096 32H (GQA kv=8) d_ff=6400(per expert) vocab=32064,
16 experts top-2.

The port's copy of ``repro/configs/phi3_5_moe.py``: the same numbers.
"""

from repro_torch.configs.base import TransformerConfig, shapes_lm

CONFIG = TransformerConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=6400,
    vocab_size=32064,
    n_experts=16,
    top_k=2,
    rope_theta=10000.0,
    tie_embeddings=False,
    param_dtype="bfloat16",
    attn_chunk=2048,   # the JAX config's KV chunk
)

SMOKE = TransformerConfig(
    name="phi3.5-moe-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=64,
    vocab_size=512,
    n_experts=4,
    top_k=2,
    tie_embeddings=False,
    remat=False,
)

SHAPES = shapes_lm(
    long_ok=False,
    long_skip_reason="pure full attention; 524k-token decode needs "
                     "sub-quadratic attention (assignment rule)",
)
