"""moonshot-v1-16b-a3b (kimi/moonlight) — MoE 64e top-6
[hf:moonshotai/Moonlight-16B-A3B].

48L d_model=2048 16H (GQA kv=16) d_ff=1408(per expert) vocab=163840,
64 experts top-6. The Sparton head is backbone-agnostic (DESIGN.md §4).

The port's copy of ``repro/configs/moonshot_v1_16b.py``: the same
numbers. By ``n_params`` they make 27.72 B parameters (48 layers of 64
experts), not the 16 B of the id; the port keeps the reference's fields.
"""

from repro_torch.configs.base import TransformerConfig, shapes_lm

CONFIG = TransformerConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=1408,
    vocab_size=163840,
    n_experts=64,
    top_k=6,
    rope_theta=50000.0,
    tie_embeddings=True,
    param_dtype="bfloat16",
    attn_chunk=2048,   # the JAX config's KV chunk
)

SMOKE = TransformerConfig(
    name="moonshot-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=64,
    vocab_size=512,
    n_experts=8,
    top_k=2,
    tie_embeddings=True,
    remat=False,
)

SHAPES = shapes_lm(
    long_ok=False,
    long_skip_reason="pure full attention; 524k-token decode needs "
                     "sub-quadratic attention (assignment rule)",
)
