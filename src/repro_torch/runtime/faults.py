"""OOM detection for the serving loop (``repro/runtime/faults.py``).

Only ``is_oom_error`` is ported: the loop halves its adaptive batch cap
on errors it recognises. The JAX module's declarative fault injector
arrives with the serving benchmarks.
"""

from __future__ import annotations

import torch

# Markers accelerator stacks put in OOM errors (XLA's RESOURCE_EXHAUSTED,
# CUDA's "out of memory"), matched on the type name and message.
_OOM_MARKERS = ("resource_exhausted", "resourceexhausted",
                "out of memory", "oom")


def is_oom_error(e: BaseException) -> bool:
    """Does this exception look like the device ran out of memory?"""
    if isinstance(e, torch.cuda.OutOfMemoryError):
        return True
    text = f"{type(e).__name__}: {e}".lower()
    return any(m in text for m in _OOM_MARKERS)
