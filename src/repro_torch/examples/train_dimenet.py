"""Train DimeNet (SMOKE) on synthetic molecules: the port's counterpart of
the JAX package's ``examples/train_dimenet.py``.

    python -m repro_torch.examples.train_dimenet [--steps 60] [--device cpu]

Exercises the triplet data pipeline (capped triplets in the dense
``(E, K)`` layout), the segment-op substrate and the AdamW training loop:
``launch.steps.build_gnn_train_step`` at lr 2e-3 on the graph-level MSE
of 8 molecules a batch, cycling over 8 batches. Prints the loss every 10
steps and exits non-zero if it did not fall. Runs on ``cuda`` unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, Optional, Sequence

import torch

from repro_torch.configs import get_config
from repro_torch.data.synthetic import molecule_batches
from repro_torch.device import resolve_device
from repro_torch.launch.steps import build_gnn_train_step, init_state
from repro_torch.sparse.triplets import build_triplets, densify_triplets

N_GRAPHS = 8


def make_batch(seed: int, device: torch.device, n_graphs: int = N_GRAPHS,
               nodes: int = 10, edges: int = 24,
               cap: int = 4) -> Dict[str, torch.Tensor]:
    """One ``molecule_batches`` draw with its triplets capped at ``cap`` a
    edge, densified to ``(E, cap)``, on ``device``."""
    b = next(molecule_batches(n_graphs=n_graphs, nodes_per_graph=nodes,
                              edges_per_graph=edges, seed=seed))
    t_in, t_out = build_triplets(b["edge_src"], b["edge_dst"],
                                 n_graphs * nodes, max_per_edge=cap)
    b["t_in_dense"], b["t_mask_dense"] = densify_triplets(
        t_in, t_out, len(b["edge_src"]), cap)
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default="cuda")
    return ap


def run(args: argparse.Namespace, device: torch.device) -> Dict:
    """Train; returns ``{"losses": [(step, loss) every 10 steps],
    "state"}``."""
    cfg = get_config("dimenet").SMOKE
    state = init_state("dimenet",
                       torch.Generator(device=device).manual_seed(0),
                       smoke=True)
    step = build_gnn_train_step(cfg, n_graphs=N_GRAPHS, lr=2e-3)
    batches = {}
    losses = []
    for i in range(args.steps):
        seed = i % 8                     # cycle a small dataset
        if seed not in batches:
            batches[seed] = make_batch(seed, device)
        state, m = step(state, batches[seed])
        if i % 10 == 0:
            losses.append((i, float(m["loss"])))
    return {"losses": losses, "state": state}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    losses = run(args, device)["losses"]
    print("loss trajectory:", [(s, round(v, 4)) for s, v in losses])
    if not losses[-1][1] < losses[0][1]:
        print("error: no learning", file=sys.stderr)
        return 1
    print(f"done: {args.steps} steps, final loss {losses[-1][1]:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
