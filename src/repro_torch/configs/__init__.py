"""Config registry of the port: ``get_config("splade_bert")``,
``get_config("llama3.2-3b")``.

``ARCHS`` are the archs the port holds: the two SPLADE encoders, which it
serves and trains (``TRAIN_ARCHS``, the train CLI's), and the three dense
and two MoE decoders, which it serves (the LSR prefill step, KV-cache
decode and the serve CLI). ``ALIASES`` are the JAX package's external
ids.
"""

from __future__ import annotations

import importlib

TRAIN_ARCHS = ("splade_bert", "splade_xlmr")
ARCHS = TRAIN_ARCHS + ("llama3_2_3b", "gemma2_27b", "phi3_mini",
                       "moonshot_v1_16b", "phi3_5_moe")

# external ids (with dots and dashes) -> module names, as in the JAX package
ALIASES = {
    "llama3.2-3b": "llama3_2_3b",
    "gemma2-27b": "gemma2_27b",
    "phi3-mini-3.8b": "phi3_mini",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe",
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
