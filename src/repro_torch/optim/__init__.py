"""Optimizers, schedules and gradient accumulation of the port."""

from repro_torch.optim.accumulation import GradAccumulator, microbatch_grads
from repro_torch.optim.optimizers import (adamw, apply_updates,
                                          clip_by_global_norm)
from repro_torch.optim.schedules import (constant_schedule,
                                         linear_warmup_cosine)

__all__ = ["GradAccumulator", "adamw", "apply_updates",
           "clip_by_global_norm", "constant_schedule",
           "linear_warmup_cosine", "microbatch_grads"]
