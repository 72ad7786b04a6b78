"""llama3.2-3b — dense GQA decoder [hf:meta-llama/Llama-3.2-3B].

28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256. Pure
full-attention => long_500k skipped. The 128k vocabulary
is squarely the paper's "larger vocabularies" motivation for the
Sparton head.

The port's copy of ``repro/configs/llama3_2_3b.py``: the same numbers; the
CUDA head picks its own tiles, so the Pallas block fields stay unset.
"""

from repro_torch.configs.base import TransformerConfig, shapes_lm

CONFIG = TransformerConfig(
    name="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_head=128,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=500000.0,
    tie_embeddings=True,
    param_dtype="bfloat16",
    attn_chunk=2048,   # the JAX config's KV chunk
)

SMOKE = TransformerConfig(
    name="llama3.2-3b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab_size=512,
    rope_theta=500000.0,
    tie_embeddings=True,
    remat=False,
)

SHAPES = shapes_lm(
    long_ok=False,
    long_skip_reason="pure full attention; 524k-token decode needs "
                     "sub-quadratic attention (assignment rule)",
)
