"""DLRM — MLPerf benchmark config (Criteo 1TB) [arXiv:1906.00091].

n_dense=13 n_sparse=26 embed_dim=128 bot=13-512-256-128
top=1024-1024-512-256-1, dot interaction. Table sizes are the MLPerf v1
Criteo-1TB day-feature cardinalities with max-ind-range=40M hashing —
the three ~40M-row tables are what force row-sharding
(repro/sparse/sharded_embedding.py).

The port's copy of ``repro/configs/dlrm_mlperf.py``: the same numbers.
Padded to ``models.recsys.ROW_PAD``, the tables hold 187,838,464 rows,
96.2 GB in f32: more than one card holds. The full CONFIG trains with
its tables row-sharded over a mesh (``launch.sharding.
recsys_param_specs``, ``sparse.sharded_embedding``,
``launch.steps.build_recsys_train_step(mesh=, ...)``): 48.44 GB of
state a rank of a (2, 2) mesh, 24.30 GB of a (2, 4) one, so with the
step's two states at its peak it needs eight 80 GB cards.
"""

from repro_torch.configs.base import RecSysConfig, SHAPES_RECSYS

# MLPerf DLRM (terabyte, max-ind-range=40000000) per-table rows
MLPERF_TABLE_SIZES = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36,
)

CONFIG = RecSysConfig(
    name="dlrm-mlperf",
    interaction="dot",
    n_dense=13,
    n_sparse=26,
    embed_dim=128,
    table_sizes=MLPERF_TABLE_SIZES,
    bot_mlp=(13, 512, 256, 128),
    top_mlp=(1024, 1024, 512, 256, 1),
)

SMOKE = RecSysConfig(
    name="dlrm-smoke",
    interaction="dot",
    n_dense=13,
    n_sparse=4,
    embed_dim=16,
    table_sizes=(100, 50, 200, 30),
    bot_mlp=(13, 32, 16),
    top_mlp=(64, 32, 1),
)

SHAPES = SHAPES_RECSYS
