"""Wide & Deep [arXiv:1606.07792].

n_sparse=40 embed_dim=32 mlp=1024-512-256, concat interaction.
Google-Play-style field cardinalities (apps/categories/user features).

The port's copy of ``repro/configs/wide_deep.py``: the same numbers.
"""

from repro_torch.configs.base import RecSysConfig, SHAPES_RECSYS

TABLE_SIZES = tuple(
    [1000000, 1000000, 500000] + [10000] * 7 + [1000] * 15 + [100] * 15
)

CONFIG = RecSysConfig(
    name="wide-deep",
    interaction="concat",
    n_sparse=40,
    embed_dim=32,
    table_sizes=TABLE_SIZES,
    mlp=(1024, 512, 256),
)

SMOKE = RecSysConfig(
    name="wide-deep-smoke",
    interaction="concat",
    n_sparse=4,
    embed_dim=8,
    table_sizes=(200, 100, 50, 30),
    mlp=(32, 16),
)

SHAPES = SHAPES_RECSYS
