"""The dry run: every (architecture x input shape) cell's step counted
on one H100 without running it (``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun          # 40 cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2_27b
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch splade_bert \\
        --json out.json

The JAX dry run lowers and compiles each cell on 512 placeholder CPU
devices and reads XLA's estimates. Eager PyTorch has no compile step, so
this one runs each cell's real step (``launch.steps.build_step``) once
on ``meta`` tensors, at the cell's published widths and shapes: the
state and the batch (``configs.specs.meta_batch``) have shapes and no
storage, nothing is allocated and no kernel is launched (K1–K3's meta
branches report their cost functions instead). A
``launch.cost_analysis.StepCounter`` counts the products by dtype, the
bytes each op moves and the live bytes at the peak, and
``roofline_terms`` turns them into times at the H100's data-sheet peaks.
It needs no card, as the JAX dry run needs no TPU.

Each record has the JAX record's keys at one device (``mesh`` "1", the
collective fields 0 or empty; ``compile_s`` holds the abstract pass's
seconds), plus ``flops_by_dtype``, ``kernel_costs`` (K1–K3's calls and
counts) and ``fits_one_card``: the peak estimate against the card's
``total_memory`` when a card is present, else the data sheet's 80 GB
(``memory_limit_source`` names which). The meshes (``--multi-pod``,
``--both-meshes``) come with multi-GPU (ROADMAP item 10) and exit 2.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs import ARCH_IDS, get_config, resolve_arch
from repro_torch.configs.base import DimeNetConfig, TransformerConfig
from repro_torch.configs.specs import (CellSpec, cell_spec, meta_batch,
                                       random_batch)
from repro_torch.launch import cost_analysis as ca
from repro_torch.launch.steps import (arch_config_for_cell, build_cell_step,
                                      init_params, new_state)

NO_MESH = ("the production meshes are not ported yet: they arrive with "
           "multi-GPU, ROADMAP Queue 1 item 10")


def memory_limit() -> Tuple[float, str]:
    """The bytes one card holds: the card's ``total_memory`` when there is
    one, else the H100 data sheet's 80 GB; and which it is."""
    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(0)
        return (float(props.total_memory),
                f"total_memory of {props.name}")
    return ca.HBM_CAPACITY, "H100 data sheet (80 GB)"


def step_inputs(cfg: Any, cell: CellSpec, generator: torch.Generator,
                device) -> Any:
    """The first argument of the cell's step on ``device``: a train state
    (``new_state``) for the ``*_train`` kinds, else the params alone."""
    if cell.step_kind.endswith("_train"):
        return new_state(cfg, generator, device=device)
    return init_params(cfg, generator, device=device)


def count_step(cfg: Any, cell: CellSpec, *, device="meta",
               stop_above: Optional[float] = None) -> Dict[str, Any]:
    """The cell's step on ``cfg`` run once under a ``StepCounter``: on
    meta tensors (the abstract pass), or on a device with random inputs
    (``configs.specs.random_batch``, seed 0). Returns the counter, the
    arguments' and the outputs' bytes and the seconds."""
    step = build_cell_step(cfg, cell)
    dev = torch.device(device)
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(0)
    first = step_inputs(cfg, cell, gen, dev)
    batch = (meta_batch(cell) if dev.type == "meta"
             else random_batch(cell, cfg, gen, dev))
    counter = ca.StepCounter(dev.type, stop_above)
    with counter:
        arg_bytes, arg_ids = ca.storage_bytes((first, batch))
        counter.track((first, batch))
        out = step(first, batch)
    out_bytes, _ = ca.storage_bytes(out, exclude=arg_ids)
    del out, first, batch
    return {"counter": counter, "argument_bytes": arg_bytes,
            "output_bytes": out_bytes, "seconds": time.perf_counter() - t0}


def abstract_pass(arch_id: str, cell: CellSpec, **kw) -> Dict[str, Any]:
    """``count_step`` on meta tensors at the cell's published config."""
    return count_step(arch_config_for_cell(arch_id, cell), cell, **kw)


def fits_one_card(arch_id: str, shape_name: str, *,
                  cell: Optional[CellSpec] = None) -> bool:
    """Whether the cell's step fits ``memory_limit()``: its abstract pass,
    stopped as soon as the live bytes pass the limit."""
    cell = cell or cell_spec(arch_id, shape_name)
    try:
        abstract_pass(resolve_arch(arch_id), cell,
                      stop_above=memory_limit()[0])
    except ca.PeakAbove:
        return False
    return True


def run_cell(arch_id: str, shape_name: str, *,
             cell: Optional[CellSpec] = None,
             verbose: bool = True) -> Dict[str, Any]:
    """One cell's record. ``cell`` replaces the published ``cell_spec``
    (a cut of it, ``configs.specs.with_rows``)."""
    arch_id = resolve_arch(arch_id)
    spec = get_config(arch_id).SHAPES[shape_name]
    rec: Dict[str, Any] = {"arch": arch_id, "shape": shape_name,
                           "mesh": "1"}
    if spec.skip:
        rec["status"] = "skipped"
        rec["reason"] = spec.skip_reason
        return rec
    cell = cell or cell_spec(arch_id, shape_name)
    run = abstract_pass(arch_id, cell)
    counter = run["counter"]
    mem = ca.memory_analysis(counter, run["argument_bytes"],
                             run["output_bytes"])
    model_flops = _model_flops(arch_id, cell)
    roof = ca.roofline_terms(counter.flops_by_dtype, counter.bytes,
                             model_flops=model_flops)
    limit, source = memory_limit()
    rec.update({
        "status": "ok",
        "step_kind": cell.step_kind,
        "n_micro": cell.n_micro,
        "batch": {k: list(v.shape) for k, v in cell.batch.items()},
        "compile_s": round(run["seconds"], 1),
        "flops_per_device": float(counter.flops),
        "flops_by_dtype": dict(counter.flops_by_dtype),
        "hbm_bytes_per_device": float(counter.bytes),
        "collective_operand_bytes": 0,
        "collective_wire_bytes": 0,
        "collective_ops": {},
        "memory_analysis": mem,
        "compute_s": roof.compute_s,
        "memory_s": roof.memory_s,
        "collective_s": roof.collective_s,
        "bottleneck": roof.bottleneck,
        "model_flops_per_device": model_flops,
        "useful_ratio": roof.useful_ratio,
        "kernel_costs": counter.kernels,
        "fits_one_card": mem["peak_estimate_bytes"] <= limit,
        "memory_limit_bytes": limit,
        "memory_limit_source": source,
    })
    if verbose:
        print(f"  [1] {arch_id}/{shape_name}: pass {rec['compile_s']}s  "
              f"flops {counter.flops:.3e}  bytes {counter.bytes:.3e}  "
              f"peak {mem['peak_estimate_bytes']:.3e}  "
              f"fits {rec['fits_one_card']}  bottleneck {roof.bottleneck}",
              flush=True)
    return rec


def _model_flops(arch_id: str, cell: CellSpec, n_dev: int = 1) -> float:
    """Useful model FLOPs per device: 6*N*D (train) / 2*N*D (forward) for
    the LMs (N the active params); the family's estimates otherwise. The
    JAX function's formulas, term for term."""
    cfg = get_config(arch_id).CONFIG
    if isinstance(cfg, TransformerConfig):
        n_active = cfg.n_active_params
        if cell.step_kind == "lsr_train":
            B, S = cell.batch["q_tokens"].shape
            tokens = 2 * B * S  # queries + docs
            return 6.0 * n_active * tokens / n_dev
        if cell.step_kind == "lsr_prefill":
            B, S = cell.batch["tokens"].shape
            return 2.0 * n_active * B * S / n_dev
        if cell.step_kind == "decode":
            B = cell.batch["tokens"].shape[0]
            # one token per sequence + attention over the cache
            attn = (2 * cfg.n_layers * cell.cache_len
                    * cfg.n_heads * cfg.d_head * 2)
            return (2.0 * n_active + attn) * B / n_dev
        return 0.0
    if isinstance(cfg, DimeNetConfig):
        # per block, per edge: msg_in/msg_out/out projections (~6 d^2)
        # + the factored bilinear (2 K nb d + 2 nb d^2); K-sum layout
        d, nb = cfg.d_hidden, cfg.n_bilinear
        K = max(1, cell.n_triplets // max(1, cell.n_edges))
        per_edge = cfg.n_blocks * (6 * d * d + 2 * K * nb * d
                                   + 2 * nb * d * d)
        fwd = cell.n_edges * per_edge
        return 3.0 * fwd / n_dev  # fwd+bwd ~ 3x fwd
    # recsys: interaction op + MLPs (embedding gathers are bytes, not
    # flops)
    if cell.step_kind == "retrieval":
        return 2.0 * cell.n_candidates * cfg.embed_dim / n_dev
    B = next(iter(cell.batch.values())).shape[0]
    d = cfg.embed_dim
    per_ex = 0.0
    if cfg.interaction == "dot":
        n_f = cfg.n_sparse + 1
        per_ex += 2 * n_f * n_f * d            # pairwise dots
        for i in range(len(cfg.bot_mlp) - 1):
            per_ex += 2 * cfg.bot_mlp[i] * cfg.bot_mlp[i + 1]
        tops = (479,) + cfg.top_mlp
        for i in range(len(tops) - 1):
            per_ex += 2 * tops[i] * tops[i + 1]
    elif cfg.interaction == "cin":
        m_f = cfg.n_sparse
        h_prev = m_f
        for h_k in cfg.cin_layers:
            per_ex += 2 * h_prev * m_f * d     # z outer products
            per_ex += 2 * h_prev * m_f * h_k * d
            h_prev = h_k
        dnn = (m_f * d,) + cfg.mlp
        for i in range(len(dnn) - 1):
            per_ex += 2 * dnn[i] * dnn[i + 1]
    elif cfg.interaction == "augru":
        g = cfg.gru_dim
        per_ex += cfg.seq_len * 2 * (2 * 3 * g * (d + g))  # 2 GRU passes
        mlp = (2 * g + d,) + cfg.mlp + (1,)
        for i in range(len(mlp) - 1):
            per_ex += 2 * mlp[i] * mlp[i + 1]
    else:  # concat
        mlp = (cfg.n_sparse * d,) + cfg.mlp + (1,)
        for i in range(len(mlp) - 1):
            per_ex += 2 * mlp[i] * mlp[i + 1]
    mult = 3.0 if cell.step_kind.endswith("train") else 1.0
    return mult * B * per_ex / n_dev


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None,
                    help="one architecture (default: the ten assigned)")
    ap.add_argument("--shape", default=None, help="one shape")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 512-device mesh (multi-GPU, item 10)")
    ap.add_argument("--both-meshes", action="store_true",
                    help="both production meshes (multi-GPU, item 10)")
    ap.add_argument("--json", default=None, help="write the records here")
    args = ap.parse_args(argv)
    if args.multi_pod or args.both_meshes:
        print(f"dryrun: {NO_MESH}", file=sys.stderr)
        return 2

    archs = [args.arch] if args.arch else list(ARCH_IDS[:10])
    records = []
    failed = 0
    for arch in archs:
        shapes = [args.shape] if args.shape else list(get_config(arch).SHAPES)
        for shape in shapes:
            try:
                records.append(run_cell(arch, shape))
            except Exception:
                failed += 1
                records.append({"arch": arch, "shape": shape, "mesh": "1",
                                "status": "FAILED",
                                "error": traceback.format_exc(limit=20)})
                print(f"  FAILED {arch}/{shape}", flush=True)
                traceback.print_exc(limit=8)

    ok = sum(1 for r in records if r.get("status") == "ok")
    sk = sum(1 for r in records if r.get("status") == "skipped")
    print(f"\ndry-run: {ok} ok, {sk} skipped, {failed} failed, "
          f"{len(records)} total", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(records, f, indent=1, default=str)
        print(f"wrote {args.json}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
