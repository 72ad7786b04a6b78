"""PyTorch port of the Sparton LSR system, with hand-written CUDA kernels
for NVIDIA Hopper (sm_90a).

The JAX package ``repro`` is the reference; this package mirrors its
module paths and imports nothing of it (nor of JAX). Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""
