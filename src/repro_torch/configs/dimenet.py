"""DimeNet — directional message-passing GNN [arXiv:2003.03123].

n_blocks=6 d_hidden=128 n_bilinear=8 n_spherical=7 n_radial=6.
Large-graph shapes cap triplets per edge (max_triplets_per_edge=8,
GemNet-OC practice); molecules use exact triplets. The input width is a
property of the shape: ``d_feat`` 0 (atom types) at molecule, the
dataset's feature width at the full-graph and sampled shapes.

The port's copy of ``repro/configs/dimenet.py``: the same numbers.
"""

from repro_torch.configs.base import DimeNetConfig, SHAPES_GNN

CONFIG = DimeNetConfig(
    name="dimenet",
    n_blocks=6,
    d_hidden=128,
    n_bilinear=8,
    n_spherical=7,
    n_radial=6,
    max_triplets_per_edge=8,   # large-graph shapes; molecule uses exact
)

SMOKE = DimeNetConfig(
    name="dimenet-smoke",
    n_blocks=2,
    d_hidden=32,
    n_bilinear=4,
    n_spherical=3,
    n_radial=4,
    max_triplets_per_edge=4,
)

SHAPES = SHAPES_GNN
