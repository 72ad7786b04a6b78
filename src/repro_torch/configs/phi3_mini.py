"""phi3-mini-3.8b — dense decoder, RoPE SwiGLU GQA [arXiv:2404.14219].

32L d_model=3072 32H (GQA kv=32 => MHA) d_ff=8192 vocab=32064. The
|V|~32k operating point matches SPLADE's (the paper's Table 1/3).
Pure full attention => long_500k skipped.

The port's copy of ``repro/configs/phi3_mini.py``: the same numbers; the
CUDA head picks its own tiles, so the Pallas block fields stay unset.
"""

from repro_torch.configs.base import TransformerConfig, shapes_lm

CONFIG = TransformerConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_head=96,
    d_ff=8192,
    vocab_size=32064,
    rope_theta=10000.0,
    tie_embeddings=False,
    param_dtype="bfloat16",
    attn_chunk=2048,   # the JAX config's KV chunk
)

SMOKE = TransformerConfig(
    name="phi3-mini-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=128,
    vocab_size=512,
    tie_embeddings=False,
    remat=False,
)

SHAPES = shapes_lm(
    long_ok=False,
    long_skip_reason="pure full attention; 524k-token decode needs "
                     "sub-quadratic attention (assignment rule)",
)
