"""Constants shared by the port's kernels and their plain versions."""

from __future__ import annotations

# Finite stand-in for -inf (as in the JAX package): keeps the streaming
# max/argmax and the running top-k well defined, and lets masked or
# padded entries lose every comparison. f32 only: it does not fit in fp16.
NEG_INF = -1e30
