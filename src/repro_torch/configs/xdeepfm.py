"""xDeepFM — Compressed Interaction Network [arXiv:1803.05170].

n_sparse=39 embed_dim=10 cin=200-200-200 mlp=400-400. Criteo layout:
13 discretized dense + 26 categorical = 39 fields; cardinalities below
follow the paper's Criteo preprocessing (hashed large fields).

The port's copy of ``repro/configs/xdeepfm.py``: the same numbers.
"""

from repro_torch.configs.base import RecSysConfig, SHAPES_RECSYS

# 13 discretized numeric fields (small) + 26 categorical (Criteo-like)
TABLE_SIZES = tuple([64] * 13 + [
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145,
    5683, 8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4,
    7046547, 18, 15, 286181, 105, 142572,
])

CONFIG = RecSysConfig(
    name="xdeepfm",
    interaction="cin",
    n_dense=0,
    n_sparse=39,
    embed_dim=10,
    table_sizes=TABLE_SIZES,
    cin_layers=(200, 200, 200),
    mlp=(400, 400),
)

SMOKE = RecSysConfig(
    name="xdeepfm-smoke",
    interaction="cin",
    n_sparse=5,
    embed_dim=8,
    table_sizes=(50, 100, 20, 80, 40),
    cin_layers=(16, 16),
    mlp=(32, 16),
)

SHAPES = SHAPES_RECSYS
