"""Training entry point of the port: ``python -m repro_torch.launch.train``.

    python -m repro_torch.launch.train --arch splade_bert --steps 3 \\
        --batch 2 --seq-len 16 --device cpu

Trains the arch's SMOKE config (``--full``: the full-width CONFIG) on
the synthetic LSR pairs of ``data.synthetic.lsr_pair_batches`` with the
step of ``launch.steps.build_lsr_train_step``, and prints the first and
the last loss. The head is the config's, the CUDA kernels K1, K2 and
K3 unless ``--head-impl`` names another. It runs on ``cuda`` unless
``--device cpu`` is given (where the kernels' plain versions run), and
exits non-zero naming CUDA when there is none. Checkpoint/resume, the
eval hook and the head autotuner wait for their slices.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from itertools import islice
from typing import Dict, Iterator, List, Tuple

import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import TransformerConfig
from repro_torch.core.head_api import available_impls
from repro_torch.data.synthetic import lsr_pair_batches
from repro_torch.device import resolve_device
from repro_torch.launch.steps import build_lsr_train_step, init_state


def train_steps(cfg: TransformerConfig, state: Dict, *, batch: int,
                seq_len: int, lr: float, device: torch.device
                ) -> Iterator[Tuple[Dict, float]]:
    """Endless train steps from ``state`` on the batches of shard 0:
    yields ``(state, loss)`` after each step."""
    step = build_lsr_train_step(cfg, lr=lr)
    for b in lsr_pair_batches(batch=batch, q_len=seq_len, d_len=seq_len,
                              vocab=cfg.vocab_size):
        b = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
        state, metrics = step(state, b)
        yield state, float(metrics["loss"])


def train(cfg: TransformerConfig, state: Dict, *, steps: int, batch: int,
          seq_len: int, lr: float, device: torch.device) -> List[float]:
    """``steps`` train steps from ``state``; returns the loss of each."""
    return [loss for _, loss in islice(
        train_steps(cfg, state, batch=batch, seq_len=seq_len, lr=lr,
                    device=device), steps)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True, choices=ARCHS)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8,
                    help="(query, doc) pairs per step")
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--full", action="store_true",
                    help="the full (published-width) config, not SMOKE")
    ap.add_argument("--lr", type=float, default=2e-4,
                    help="peak learning rate (1000 warm-up steps, cosine)")
    ap.add_argument("--head-impl", default=None,
                    choices=("jax",) + available_impls(),
                    help="override the config's head backend (default "
                         "kernel: K1 forward, K2 and K3 backward)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "versions")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))

    mod = get_config(args.arch)
    cfg = mod.CONFIG if args.full else mod.SMOKE
    if args.head_impl:
        cfg = dataclasses.replace(cfg, head_impl=args.head_impl)
    state = init_state(args.arch,
                       torch.Generator(device=device).manual_seed(0),
                       smoke=not args.full)
    losses = train(cfg, state, steps=args.steps, batch=args.batch,
                   seq_len=args.seq_len, lr=args.lr, device=device)
    if losses:
        print(f"step {len(losses)}: loss {losses[-1]:.4f} "
              f"(first {losses[0]:.4f})")
    print(f"done: {args.steps} steps of {cfg.name} "
          f"(head {cfg.head_spec().impl}) on {device}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
