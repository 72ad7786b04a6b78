"""DIEN — interest evolution with AUGRU [arXiv:1809.03672].

embed_dim=18 seq_len=100 gru_dim=108 mlp=200-80, AUGRU interaction.
Item vocabulary sized to Amazon-Books scale (~370k items).

The port's copy of ``repro/configs/dien.py``: the same numbers.
"""

from repro_torch.configs.base import RecSysConfig, SHAPES_RECSYS

CONFIG = RecSysConfig(
    name="dien",
    interaction="augru",
    n_sparse=1,
    embed_dim=18,
    table_sizes=(367983,),
    seq_len=100,
    gru_dim=108,
    mlp=(200, 80),
)

SMOKE = RecSysConfig(
    name="dien-smoke",
    interaction="augru",
    n_sparse=1,
    embed_dim=8,
    table_sizes=(500,),
    seq_len=12,
    gru_dim=16,
    mlp=(24, 12),
)

SHAPES = SHAPES_RECSYS
