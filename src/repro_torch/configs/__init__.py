"""Config registry of the port: ``get_config("splade_bert")``,
``get_config("llama3.2-3b")``.

``ARCHS`` are the archs the port holds. The two SPLADE encoders, the
three dense decoders and the two MoE decoders are served (the LSR
prefill step, the serve CLI; KV-cache decode for a decoder) and trained
(the LSR train step, the train CLI). The four recsys archs
(``RECSYS_ARCHS``) are trained by the train CLI (Adagrad on the CTR
loss), served by ``launch.steps.build_recsys_serve_step`` and retrieve
through ``build_retrieval_step``. DimeNet (``dimenet``, the GNN family)
trains through ``launch.steps.build_gnn_train_step`` and
``examples.train_dimenet``; both CLIs refuse it, as the JAX CLI does.
``ALIASES`` are the JAX package's external ids. ``ARCH_IDS`` is the
JAX package's registry order, which the dry run's matrix
(``all_cells``) follows: the ten assigned archs, then the paper's two
encoders.
"""

from __future__ import annotations

import importlib

RECSYS_ARCHS = ("dlrm_mlperf", "xdeepfm", "dien", "wide_deep")
GNN_ARCHS = ("dimenet",)
ARCHS = ("splade_bert", "splade_xlmr", "llama3_2_3b", "gemma2_27b",
         "phi3_mini", "moonshot_v1_16b", "phi3_5_moe") + RECSYS_ARCHS \
    + GNN_ARCHS

# the JAX registry's order (``repro/configs/__init__.py``)
ARCH_IDS = ("llama3_2_3b", "gemma2_27b", "phi3_mini", "moonshot_v1_16b",
            "phi3_5_moe", "dimenet", "dlrm_mlperf", "xdeepfm", "dien",
            "wide_deep", "splade_bert", "splade_xlmr")

# external ids (with dots and dashes) -> module names, as in the JAX package
ALIASES = {
    "llama3.2-3b": "llama3_2_3b",
    "gemma2-27b": "gemma2_27b",
    "phi3-mini-3.8b": "phi3_mini",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe",
    "dimenet": "dimenet",
    "dlrm-mlperf": "dlrm_mlperf",
    "xdeepfm": "xdeepfm",
    "dien": "dien",
    "wide-deep": "wide_deep",
    "splade-bert": "splade_bert",
    "splade-xlmr": "splade_xlmr",
}


def resolve_arch(arch_id: str) -> str:
    """The module name of an arch id or alias. Raises ``ValueError`` for an
    unknown id."""
    name = ALIASES.get(arch_id, arch_id)
    if name not in ARCHS:
        raise ValueError(f"unknown arch {arch_id!r}; the port has "
                         f"{list(ARCHS)} and the aliases "
                         f"{sorted(k for k, v in ALIASES.items() if v in ARCHS)}")
    return name


def get_config(arch_id: str):
    """The config module (``CONFIG``, ``SMOKE``, ``SHAPES``) of an arch."""
    return importlib.import_module(f"repro_torch.configs.{resolve_arch(arch_id)}")


def all_cells(include_paper_models: bool = False):
    """Yields ``(arch_id, shape_name, ShapeSpec)`` for the dry run's
    matrix: the ten assigned archs' shapes (40 cells, 4 of them skipped),
    with ``include_paper_models`` also the two SPLADE encoders' (45)."""
    ids = ARCH_IDS if include_paper_models else ARCH_IDS[:10]
    for arch in ids:
        for shape_name, spec in get_config(arch).SHAPES.items():
            yield arch, shape_name, spec
