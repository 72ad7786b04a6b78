"""Train-state checkpoints in the JAX package's format
(``repro/checkpoint``)."""

from repro_torch.checkpoint.store import (
    AsyncCheckpointer,
    latest_step,
    load_checkpoint,
    save_checkpoint,
)

__all__ = ["AsyncCheckpointer", "latest_step", "load_checkpoint",
           "save_checkpoint"]
