"""SPLADE on an xlm-roberta-base backbone — the paper's multilingual model.

Bidirectional encoder, |V| = 250002, 12L/768/12H, tied embeddings: the
regime where the paper reports Sparton's largest gains (a 26x larger
batch, 2.5x faster training on an H100, §4.1; train_16 -> train_420).
The port's copy of ``repro/configs/splade_xlmr.py``; the CUDA head picks
its own tiles, so the Pallas block fields stay unset.
"""

from repro_torch.configs.base import ShapeSpec, TransformerConfig

CONFIG = TransformerConfig(
    name="splade-xlmr",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_head=64,
    d_ff=3072,
    vocab_size=250002,
    bidirectional_encoder=True,
    tie_embeddings=True,
)

SMOKE = TransformerConfig(
    name="splade-xlmr-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=128,
    vocab_size=1024,
    bidirectional_encoder=True,
    tie_embeddings=True,
    remat=False,
)

SHAPES = {
    "train_16": ShapeSpec("train_16", "train", seq_len=256, global_batch=16),
    "train_420": ShapeSpec("train_420", "train", seq_len=256,
                           global_batch=420),
}
