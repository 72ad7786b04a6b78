"""Training entry point of the port: ``python -m repro_torch.launch.train``.

    python -m repro_torch.launch.train --arch splade_bert --steps 3 \\
        --batch 2 --seq-len 16 --device cpu
    python -m repro_torch.launch.train --arch splade_bert --steps 2 \\
        --batch 2 --seq-len 16 --eval-every 1 --eval-queries 8 --device cpu
    python -m repro_torch.launch.train --arch splade_bert --steps 4 \\
        --batch 2 --seq-len 16 --ckpt-dir /tmp/ck --resume --device cpu
    python -m repro_torch.launch.train --arch splade_xlmr --full \\
        --batch 16 --seq-len 256
    python -m repro_torch.launch.train --arch llama3.2-3b --steps 2 \\
        --batch 2 --seq-len 16 --device cpu
    python -m repro_torch.launch.train --arch xdeepfm --steps 3 \\
        --batch 16 --device cpu
    python -m repro_torch.launch.train --arch xdeepfm --full --batch 32768

Trains any arch of ``configs.ARCHS`` or its JAX alias, as the JAX CLI
trains any ``TransformerConfig`` and ``RecSysConfig``. ``--arch dimenet``
exits non-zero with the JAX CLI's message, "use examples/train_dimenet.py
for the GNN family": DimeNet trains through
``python -m repro_torch.examples.train_dimenet``.

A recsys arch (``dlrm_mlperf``, ``xdeepfm``, ``dien``, ``wide_deep``)
trains its SMOKE config (``--full``: the published CONFIG) on the click
batches of ``data.synthetic.recsys_batches`` (``--batch`` rows a step),
through the same loader, with ``launch.steps.build_recsys_train_step``:
the mean BCE of the click logits, Adagrad at 1e-2, the rate the JAX CLI
trains it at (it passes no ``--lr`` to that step, nor does this CLI).
``--seq-len``, the regularizer, head and eval flags touch a
``TransformerConfig`` only, as in the JAX CLI. DLRM's published tables
(96.2 GB in f32) fit on no one card, and this CLI runs one process:
they train row-sharded in a world of ranks, through
``build_recsys_train_step(cfg, mesh=, param_specs=, zero_specs=)``
(48.44 GB of state a rank of a (2, 2) mesh).

An LSR arch trains as follows: the SPLADE encoders, the dense decoders
(llama3.2-3b, gemma2-27b, phi3-mini) and the MoE decoders
(moonshot-v1-16b-a3b, phi3.5-moe, whose objective adds the load-balance
term ``aux_weight * (aux_q + aux_d)``). It trains the arch's SMOKE config
(``--full``: the published CONFIG, bf16 params for a decoder) on
the synthetic LSR pairs of ``data.synthetic.lsr_pair_batches``, fed
through ``data.loader.HostShardedLoader`` (a prefetch thread; on the card
the batches sit in pinned host memory and are copied with
``non_blocking=True``), with the step of
``launch.steps.build_lsr_train_step``, and prints the first and the last
loss. The head is the config's, the CUDA kernels K1, K2 and K3 unless
``--head-impl`` names another; ``--lambda-q``, ``--lambda-d`` and
``--l1-weight`` replace the config's regularizer weights when given, as
in the JAX CLI. It runs on ``cuda`` unless ``--device cpu`` is given
(where the kernels' plain versions run), and exits non-zero naming CUDA
when there is none.

``--eval-every N`` scores retrieval on ``--eval-queries`` held-out
(query, positive doc) pairs (``lsr_pair_batches`` with seed 9173, which
no training shard draws) at init, every N steps and at the last step:
the params' dense head output, sparsified to 64 terms a row, indexed
and searched with the ``exact`` method (``eval.evaluate_retrieval``;
``auto`` reaches the fused kernel K4 from 16384 docs), MRR@10 and
nDCG@10, printed as the JAX CLI prints them (``eval @ init: ...``,
``eval @ step N: ...``, ``eval improvement over init: ...``).

The run goes through ``runtime.fault_tolerance.FaultTolerantRunner``,
as the JAX CLI's does: an async atomic checkpoint of the whole state
(params, AdamW moments or Adagrad accumulators, step) into
``--ckpt-dir`` every ``--ckpt-every`` steps and once at the end, in the
JAX package's format (a checkpoint of either CLI resumes in the other);
``--resume`` loads the latest and prints ``resumed from step N``. As in
the JAX runner, a resumed run draws its batches from the start of a
fresh stream, while the schedule goes on from the state's step. A step past the runner's deadline is
retried, then skipped; a step that raises is skipped by the runner too,
and the CLI then exits non-zero naming the first such error (a kernel
that does not build or launch must not end in ``done``).

The JAX CLI's ``--autotune-head`` arrives with block selection (ROADMAP
Queue 1 item 2). ``--overlap`` has no CUDA counterpart: it sets XLA's
TPU scheduler flags.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Callable, Dict, Iterator, List, Optional, Tuple, Union

import torch

from repro_torch.configs import ARCHS, get_config, resolve_arch
from repro_torch.configs.base import (DimeNetConfig, RecSysConfig,
                                      TransformerConfig)
from repro_torch.core.head_api import available_impls
from repro_torch.data.loader import HostShardedLoader
from repro_torch.data.synthetic import lsr_pair_batches, recsys_batches
from repro_torch.device import resolve_device
from repro_torch.eval import MethodSpec, Qrels, evaluate_retrieval
from repro_torch.launch.steps import (Batch, build_lsr_train_step,
                                      build_recsys_train_step, init_state)
from repro_torch.runtime.fault_tolerance import (FaultTolerantRunner,
                                                RunnerConfig)
from repro_torch.runtime.serving import make_config_encoder


REGULARIZERS = ("lambda_q", "lambda_d", "l1_weight")
EVAL_SEED = 9173      # held-out pairs: a seed no training shard draws
# the JAX CLI's words for the GNN family, which it does not train
GNN_REFUSAL = "use examples/train_dimenet.py for the GNN family"


def pair_loader(cfg: TransformerConfig, *, batch: int, seq_len: int,
                device: torch.device) -> HostShardedLoader:
    """Shard 0's synthetic (query, doc) pairs through a
    ``HostShardedLoader``, pinned when they go to the card."""
    def make_iter(shard, n_shards):
        return lsr_pair_batches(batch=batch, q_len=seq_len, d_len=seq_len,
                                vocab=cfg.vocab_size, shard=shard)

    return HostShardedLoader(make_iter, pin_memory=device.type == "cuda")


def recsys_loader(cfg: RecSysConfig, *, batch: int,
                  device: torch.device) -> HostShardedLoader:
    """Shard 0's synthetic click batches (``recsys_batches`` over the
    config's tables) through a ``HostShardedLoader``, pinned when they go
    to the card."""
    def make_iter(shard, n_shards):
        return recsys_batches(batch=batch, n_dense=cfg.n_dense,
                              n_sparse=cfg.n_sparse,
                              table_sizes=cfg.table_sizes,
                              seq_len=cfg.seq_len, shard=shard)

    return HostShardedLoader(make_iter, pin_memory=device.type == "cuda")


def placer(device: torch.device) -> Callable[[Batch], Batch]:
    """A host batch -> the same tensors on ``device``."""
    return lambda b: {k: v.to(device, non_blocking=True)
                      for k, v in b.items()}


def make_runner(cfg: Union[TransformerConfig, RecSysConfig], state: Dict,
                batches: Iterator, *, steps: int, lr: Optional[float],
                device: torch.device, ckpt_dir: str, ckpt_every: int = 0,
                on_step: Optional[Callable[[int, Dict], Optional[Dict]]]
                = None) -> FaultTolerantRunner:
    """The CLI's training loop: a ``FaultTolerantRunner`` over
    ``build_lsr_train_step(cfg, lr=lr)`` (a ``RecSysConfig``:
    ``build_recsys_train_step(cfg, lr=lr)``, its own 1e-2 when ``lr`` is
    None) from ``state`` up to step ``steps``, on host ``batches`` placed
    on ``device``, each step's metrics logged. It checkpoints into
    ``ckpt_dir`` every ``ckpt_every`` steps (0: never) and, as the JAX
    runner does, once at the end."""
    if isinstance(cfg, RecSysConfig):
        step = build_recsys_train_step(
            cfg, **({} if lr is None else {"lr": lr}))
    else:
        step = build_lsr_train_step(cfg, lr=lr)
    return FaultTolerantRunner(
        step, state, batches,
        config=RunnerConfig(ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                            max_steps=steps, log_every=1),
        place_batch=placer(device), on_step=on_step)


def held_out(cfg: TransformerConfig, n: int, *, q_len: int, d_len: int
             ) -> Tuple[Dict, Qrels]:
    """``n`` held-out (query, positive doc) pairs as a token corpus for
    ``eval.evaluate_retrieval``, and their judgments (query i's sole
    relevant doc is doc i)."""
    pairs = next(lsr_pair_batches(batch=n, q_len=q_len, d_len=d_len,
                                  vocab=cfg.vocab_size, seed=EVAL_SEED))
    corpus = {"doc_tokens": pairs["d_tokens"], "doc_mask": pairs["d_mask"],
              "q_tokens": pairs["q_tokens"], "q_mask": pairs["q_mask"],
              "vocab_size": cfg.vocab_size}
    return corpus, Qrels.paired(n)


def evaluator(cfg: TransformerConfig, corpus: Dict, qrels: Qrels, *,
              device: torch.device) -> Callable[[Dict], Dict[str, float]]:
    """``state -> {"mrr@10": ..., "ndcg@10": ...}``: the ``exact`` method
    over ``corpus``, encoded without autograd by the config's head on the
    state's current params (the dense ``(B, V)`` output, sparsified to 64
    terms a row), in chunks of ``min(32, n_queries)`` rows."""
    batch = min(32, len(qrels))
    spec = cfg.head_spec(rep_topk=None, rep_threshold=None)

    def run_eval(state: Dict) -> Dict[str, float]:
        encode = make_config_encoder(state["params"], cfg, spec=spec)
        res = evaluate_retrieval(
            encode, corpus, qrels, methods=(MethodSpec("exact"),),
            ks=(10,), metrics=("mrr", "ndcg"), batch=batch, device=device)
        return res["exact"]

    return run_eval


def _metrics_line(metrics: Dict[str, float]) -> str:
    return " ".join(f"{k} {v:.4f}" for k, v in metrics.items())


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True,
                    help=f"one of {', '.join(ARCHS)} (or its JAX "
                         f"alias)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8,
                    help="(query, doc) pairs per step (recsys: click rows)")
    ap.add_argument("--seq-len", type=int, default=32,
                    help="query and doc tokens (LSR archs only)")
    ap.add_argument("--ckpt-dir", default="/tmp/repro_ckpt",
                    help="where checkpoints are written and resumed from")
    ap.add_argument("--ckpt-every", type=int, default=20,
                    help="checkpoint every N steps (and at the end)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint in --ckpt-dir")
    ap.add_argument("--full", action="store_true",
                    help="the full (published-width) config, not SMOKE")
    ap.add_argument("--lr", type=float, default=2e-4,
                    help="peak learning rate (1000 warm-up steps, cosine) "
                         "of the LSR step; a recsys arch trains at 1e-2, "
                         "as the JAX CLI trains it")
    ap.add_argument("--lambda-q", type=float, default=None,
                    help="FLOPS regularizer weight on query reps "
                         "(default: config's lambda_q)")
    ap.add_argument("--lambda-d", type=float, default=None,
                    help="FLOPS regularizer weight on doc reps "
                         "(default: config's lambda_d)")
    ap.add_argument("--l1-weight", type=float, default=None,
                    help="L1 rep regularizer weight "
                         "(default: config's l1_weight)")
    ap.add_argument("--eval-every", type=int, default=0,
                    help="every N steps, run retrieval eval (MRR@10/"
                         "nDCG@10 on a held-out paired batch) and log "
                         "it; also evals the untrained init and prints "
                         "the improvement at the end. 0 = off")
    ap.add_argument("--eval-queries", type=int, default=32,
                    help="held-out (query, positive-doc) pairs scored "
                         "by --eval-every")
    ap.add_argument("--head-impl", default=None,
                    choices=("jax",) + available_impls(),
                    help="override the config's head backend (default "
                         "kernel: K1 forward, K2 and K3 backward)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "versions")
    return ap


def config_from_args(args: argparse.Namespace
                     ) -> Union[TransformerConfig, RecSysConfig]:
    """The arch's SMOKE or CONFIG with the flags that override its fields
    (each only when given; a ``RecSysConfig`` has none of them)."""
    mod = get_config(args.arch)
    cfg = mod.CONFIG if args.full else mod.SMOKE
    if isinstance(cfg, DimeNetConfig):
        raise SystemExit(GNN_REFUSAL)
    if isinstance(cfg, RecSysConfig):
        return cfg
    reg = {name: getattr(args, name) for name in REGULARIZERS
           if getattr(args, name) is not None}
    if reg:
        cfg = dataclasses.replace(cfg, **reg)
    if args.head_impl:
        cfg = dataclasses.replace(cfg, head_impl=args.head_impl)
    return cfg


class TrainStepError(RuntimeError):
    """A train step raised: the runner skipped it, the run must fail."""


def run(args: argparse.Namespace, device: torch.device) -> Dict:
    """The CLI's run from parsed ``args``: trains under a
    ``FaultTolerantRunner`` (resuming as ``--resume`` asks), evaluates as
    ``--eval-every`` asks and prints the JAX CLI's lines. Returns
    ``{"losses": [loss of each step run], "init": metrics or None,
    "evals": [(step, metrics), ...], "state": the final state,
    "start_step", "skipped": [step, ...]}``.
    Raises ``TrainStepError`` naming the first error when a step raised."""
    cfg = config_from_args(args)
    recsys = isinstance(cfg, RecSysConfig)
    state = init_state(args.arch,
                       torch.Generator(device=device).manual_seed(0),
                       smoke=not args.full)
    run_eval = None
    if args.eval_every and not recsys:
        run_eval = evaluator(cfg, *held_out(
            cfg, args.eval_queries, q_len=args.seq_len,
            d_len=args.seq_len), device=device)
    evals: List[Tuple[int, Dict[str, float]]] = []

    def eval_hook(step_idx: int, state: Dict) -> Optional[Dict]:
        done = step_idx + 1
        if done % args.eval_every and done != args.steps:
            return None
        evals.append((done, run_eval(state)))
        print(f"eval @ step {done}: " + _metrics_line(evals[-1][1]))
        return {f"eval_{k}": v for k, v in evals[-1][1].items()}

    if recsys:
        loader = recsys_loader(cfg, batch=args.batch, device=device)
    else:
        loader = pair_loader(cfg, batch=args.batch, seq_len=args.seq_len,
                             device=device)
    with loader:
        runner = make_runner(
            cfg, state, iter(loader), steps=args.steps,
            lr=None if recsys else args.lr,
            device=device, ckpt_dir=args.ckpt_dir,
            ckpt_every=args.ckpt_every,
            on_step=eval_hook if run_eval else None)
        if args.resume and runner.try_resume():
            print(f"resumed from step {runner.start_step}")
        # the untrained init, as the JAX CLI evaluates it, also on resume
        init_metrics = run_eval(state) if run_eval else None
        if init_metrics:
            print("eval @ init: " + _metrics_line(init_metrics))
        del state   # the runner holds the state it trains: no copy beside it
        state = runner.run()
    logged = [m for m in runner.metrics_log if "loss" in m]
    losses = [float(m["loss"]) for m in logged]
    if losses:
        print(f"step {logged[-1]['step'] + 1}: loss {losses[-1]:.4f} "
              f"(first {losses[0]:.4f})")
    if init_metrics and evals:
        final = evals[-1][1]
        print("eval improvement over init: " + " ".join(
            f"{k} {init_metrics[k]:.4f}->{final[k]:.4f}"
            f"({final[k] - init_metrics[k]:+.4f})" for k in final))
    what = ("Adagrad" if recsys else f"head {cfg.head_spec().impl}")
    print(f"done: {args.steps} steps of {cfg.name} ({what}) on {device}, "
          f"{len(runner.skipped_steps)} skipped, "
          f"{len(runner.remesh_events)} re-mesh events")
    if runner.errors:
        step_idx, error = runner.errors[0]
        raise TrainStepError(f"{len(runner.errors)} train step(s) raised; "
                             f"the first, step {step_idx}: {error}")
    return {"losses": losses, "init": init_metrics, "evals": evals,
            "state": state, "start_step": runner.start_step,
            "skipped": runner.skipped_steps}


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    try:
        resolve_arch(args.arch)
    except ValueError as e:
        ap.error(str(e))
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    try:
        run(args, device)
    except TrainStepError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
