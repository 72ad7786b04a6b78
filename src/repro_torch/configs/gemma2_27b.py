"""gemma2-27b — local/global alternating attention + logit softcaps
[arXiv:2408.00118].

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000. The 256k
vocabulary matches the paper's xlm-roberta (250k) scenario where the
Sparton gains were largest (26x batch, 2.5x speed). Hybrid
local(4096-window)/global attention => long_500k RUNS (KV for local
layers bounded by the window; global layers decode O(S) with a
sequence-sharded cache).

The port's copy of ``repro/configs/gemma2_27b.py``: the same numbers; the
CUDA head picks its own tiles, so the Pallas block fields stay unset.
"""

from repro_torch.configs.base import TransformerConfig, shapes_lm

CONFIG = TransformerConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    d_head=144,
    d_ff=36864,
    vocab_size=256000,
    sliding_window=4096,
    local_global_alternating=True,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    rope_theta=10000.0,
    tie_embeddings=True,
    param_dtype="bfloat16",
    attn_chunk=2048,   # the JAX config's KV chunk
)

SMOKE = TransformerConfig(
    name="gemma2-27b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=256,
    vocab_size=512,
    sliding_window=16,
    local_global_alternating=True,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    tie_embeddings=True,
    remat=False,
)

SHAPES = shapes_lm(long_ok=True)
