"""Quickstart: the Sparton head through the unified head API, the port's
counterpart of the JAX package's ``examples/quickstart.py``.

    python -m repro_torch.examples.quickstart [--device cpu]

The paper's contribution (Eq. 1) behind one seam: a ``HeadSpec``
describes the head, a registry holds the backends (naive / tiled /
sparton / kernel) and ``make_head`` returns one callable. At B 4, S 64,
D 128 and bert-base's vocabulary (30522): sparton against naive, the
kernel head (K1 forward on the card) against sparton, gradients through
the sparton head, and ``sparton_forward_with_indices``' top dims of
example 0 with the token that activated each. Runs on ``cuda`` unless
``--device cpu`` is given; raises if the kernel head and sparton differ
by more than ``KERNEL_TOL``.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, Optional, Sequence

import torch

from repro_torch.core.head_api import HeadSpec, available_impls, make_head
from repro_torch.core.lm_head import sparton_forward_with_indices
from repro_torch.device import resolve_device

B, S, D, V = 4, 64, 128, 30522  # bert-base-uncased vocabulary
# the kernel head against sparton, as tests/test_torch_sparton_head.py
# holds them (its TOL): |kernel - sparton| <= KERNEL_TOL * (1 + |sparton|)
KERNEL_TOL = 1e-5


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "versions")
    return ap


def run(args: argparse.Namespace, device: torch.device) -> Dict:
    """The quickstart's sections; returns the printed differences
    (``sparton_vs_naive``, ``kernel_vs_sparton``), the active dims, the
    gradients' shapes and the top dims of example 0 with their tokens."""
    g = torch.Generator(device=device).manual_seed(0)
    H = torch.randn((B, S, D), generator=g, device=device)  # hidden states
    E = torch.randn((V, D), generator=g, device=device) * 0.05  # embeddings
    b = torch.randn((V,), generator=g, device=device) * 0.05    # head bias
    mask = (torch.rand((B, S), generator=g, device=device) > 0.1).int()

    # --- one spec, every backend ----------------------------------------
    print("registered head impls:", available_impls())
    spec = HeadSpec(impl="sparton", vocab_tile=4096)
    head = make_head(spec)
    y_sparton = head(H, E, b, mask)
    y_naive = make_head(spec.replace(impl="naive"))(H, E, b, mask)
    sparton_vs_naive = float((y_sparton - y_naive).abs().max())
    print("output shape:", tuple(y_sparton.shape))
    print("max |sparton - naive|:", sparton_vs_naive)
    active = float((y_sparton > 0).sum(-1).float().mean())
    print(f"active vocab dims per example: {active:.0f} / {V} (untrained "
          "weights are dense; the FLOPS regularizer induces sparsity during "
          "training — see repro_torch.examples.train_splade)")

    # --- the kernel is just another registry entry ----------------------
    # The JAX quickstart pins interpret=True and TPU blocks here; the
    # port's spec has no interpreter and K1 picks its own tiles (the
    # "kernel" backend refuses pinned blocks), so only the impl changes.
    # On the CPU the backend runs K1's plain version.
    y_kernel = make_head(spec.replace(impl="kernel"))(H, E, b, mask)
    kernel_err = (y_kernel - y_sparton).abs()
    kernel_vs_sparton = float(kernel_err.max())
    print("max |kernel - sparton|:", kernel_vs_sparton)
    if not bool((kernel_err <= KERNEL_TOL * (1 + y_sparton.abs())).all()):
        raise RuntimeError(
            f"the kernel head differs from sparton by {kernel_vs_sparton}, "
            f"past {KERNEL_TOL} relative to 1 + |y|")

    # --- the memory story: residuals are (y, i_max), not (B, S, V) ------
    leaves = [t.detach().requires_grad_(True) for t in (H, E, b)]
    y = head(*leaves, mask)
    grads = torch.autograd.grad((y * y).sum(), leaves)
    print("grad shapes:", [tuple(gr.shape) for gr in grads])

    # --- interpretability: which token activated each vocab dim ---------
    y, i_max = sparton_forward_with_indices(H, E, b, mask)
    top_dims = torch.argsort(-y[0], stable=True)[:5]
    tokens = i_max[0, top_dims]
    print("example 0 — top vocab dims:", top_dims.tolist(),
          "activated at tokens:", tokens.tolist())
    return {"sparton_vs_naive": sparton_vs_naive,
            "kernel_vs_sparton": kernel_vs_sparton, "active": active,
            "grad_shapes": [tuple(gr.shape) for gr in grads],
            "grads_finite": all(bool(gr.isfinite().all()) for gr in grads),
            "top_dims": top_dims.tolist(), "top_tokens": tokens.tolist(),
            "inputs": (H, E, b, mask)}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    run(args, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
