"""Optimizers, schedules and gradient accumulation of the port."""

from repro_torch.optim.accumulation import GradAccumulator, microbatch_grads
from repro_torch.optim.optimizers import (adagrad, adamw, apply_updates,
                                          clip_by_global_norm, sgd_momentum)
from repro_torch.optim.schedules import (constant_schedule, cosine_schedule,
                                         linear_warmup_cosine,
                                         linear_warmup_linear_decay)

__all__ = ["GradAccumulator", "adagrad", "adamw", "apply_updates",
           "clip_by_global_norm", "constant_schedule", "cosine_schedule",
           "linear_warmup_cosine", "linear_warmup_linear_decay",
           "microbatch_grads", "sgd_momentum"]
