"""SPLADE on a BERT-base backbone — the paper's own model (Table 1, 3).

Bidirectional encoder, |V| = 30522 (bert-base-uncased), 12L/768/12H:
the operating point of the paper's Table 1 (B=320, S=512 on an H100).
The port's copy of ``repro/configs/splade_bert.py``.
"""

from repro_torch.configs.base import ShapeSpec, TransformerConfig

CONFIG = TransformerConfig(
    name="splade-bert",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_head=64,
    d_ff=3072,
    vocab_size=30522,
    bidirectional_encoder=True,
    tie_embeddings=True,
)

SMOKE = TransformerConfig(
    name="splade-bert-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=128,
    vocab_size=512,
    bidirectional_encoder=True,
    tie_embeddings=True,
)

# the paper's measurement points
SHAPES = {
    "table1": ShapeSpec("table1", "train", seq_len=512, global_batch=320),
    "table3_384": ShapeSpec("table3_384", "train", seq_len=256,
                            global_batch=384),
    "table3_512": ShapeSpec("table3_512", "train", seq_len=256,
                            global_batch=512),
}
