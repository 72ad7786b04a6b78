"""Train a SPLADE-style sparse encoder (SMOKE splade_bert) for a few
hundred steps through the fault-tolerant runner: the port's counterpart
of the JAX package's ``examples/train_splade.py``.

    python -m repro_torch.examples.train_splade [--steps 200] [--device cpu]

Synthetic LSR pairs -> ``HostShardedLoader`` -> ``FaultTolerantRunner``
(async atomic checkpoints every 50 steps, auto-resume, the straggler
policy) -> the SPLADE objective through the config's head (K1, K2 and K3
on the card) over 2 micro-batches -> AdamW. Then the in-batch retrieval
check: do 32 held-out queries (seed 123) score their own doc highest?
Runs on ``cuda`` unless ``--device cpu`` is given. Exits non-zero if a
step raised or the loss did not fall.
"""

from __future__ import annotations

import argparse
import shutil
import sys
import tempfile
from typing import Dict, Optional, Sequence

import torch

from repro_torch.configs import get_config
from repro_torch.data.synthetic import lsr_pair_batches
from repro_torch.device import resolve_device
from repro_torch.launch.steps import build_lsr_train_step, init_state
from repro_torch.launch.train import pair_loader, placer
from repro_torch.runtime.fault_tolerance import (FaultTolerantRunner,
                                                RunnerConfig)
from repro_torch.runtime.serving import make_config_encoder

PROBE_PAIRS = 32
PROBE_SEED = 123


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=24)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a temporary one, "
                         "removed at the end)")
    ap.add_argument("--device", default="cuda")
    return ap


def run(args: argparse.Namespace, device: torch.device) -> Dict:
    """Train, then probe; returns ``{"losses": [(step, loss), ...],
    "acc": in-batch acc@1, "active": mean active dims of a query, "start_step",
    "skipped"}``."""
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="splade_ckpt_")
    try:
        cfg = get_config("splade_bert").SMOKE
        state = init_state("splade_bert",
                           torch.Generator(device=device).manual_seed(0),
                           smoke=True)
        step = build_lsr_train_step(cfg, n_micro=2, lr=args.lr,
                                    total_steps=args.steps)
        with pair_loader(cfg, batch=args.batch, seq_len=args.seq_len,
                         device=device) as loader:
            runner = FaultTolerantRunner(
                step, state, iter(loader),
                config=RunnerConfig(ckpt_dir=ckpt_dir, ckpt_every=50,
                                    max_steps=args.steps, log_every=20),
                place_batch=placer(device))
            if runner.try_resume():
                print(f"resumed from checkpoint at step {runner.start_step}")
            state = runner.run()
    finally:
        if args.ckpt_dir is None:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    if runner.errors:
        raise RuntimeError(f"train step {runner.errors[0][0]} raised: "
                           f"{runner.errors[0][1]}")

    losses = [(m["step"], float(m["loss"])) for m in runner.metrics_log]
    print("loss trajectory:", [(s, round(v, 3)) for s, v in losses])
    if not losses[-1][1] < losses[0][1]:
        raise RuntimeError(f"training did not reduce the loss: {losses}")

    # quick retrieval sanity: does query i retrieve doc i?
    b = next(lsr_pair_batches(batch=PROBE_PAIRS, q_len=args.seq_len,
                              d_len=args.seq_len, vocab=cfg.vocab_size,
                              seed=PROBE_SEED))
    encode = make_config_encoder(state["params"], cfg)
    yq = encode(torch.from_numpy(b["q_tokens"]), torch.from_numpy(b["q_mask"]))
    yd = encode(torch.from_numpy(b["d_tokens"]), torch.from_numpy(b["d_mask"]))
    scores = (yq.float() @ yd.float().T).cpu()
    acc = float((scores.argmax(1) == torch.arange(PROBE_PAIRS)).float().mean())
    active = float((yq > 0).sum(-1).float().mean())
    print(f"in-batch retrieval acc@1: {acc:.2f}  (chance "
          f"{1 / PROBE_PAIRS:.3f}); mean active dims {active:.0f}")
    return {"losses": losses, "acc": acc, "active": active,
            "start_step": runner.start_step,
            "skipped": runner.skipped_steps}


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
