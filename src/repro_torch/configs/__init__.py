"""Config registry of the port: ``get_config("splade_bert")``,
``get_config("splade_xlmr")``."""

from __future__ import annotations

import importlib

ARCHS = ("splade_bert", "splade_xlmr")


def get_config(arch_id: str):
    """The config module (``CONFIG``, ``SMOKE``, ``SHAPES``) of an arch."""
    if arch_id not in ARCHS:
        raise ValueError(f"unknown arch {arch_id!r}; the port has "
                         f"{list(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{arch_id}")
