"""Per-cell input specs (``repro/configs/specs.py``): for every
(architecture x shape) cell, which step it runs and the shapes and dtypes
of that step's batch, without allocating anything.

``cell_spec(arch_id, shape_name)`` returns a ``CellSpec``:
  * ``step_kind`` — the step the cell runs (lsr_train / lsr_prefill /
    decode / gnn_train / recsys_train / recsys_serve / retrieval),
  * ``batch`` — a dict of ``TensorSpec(shape, dtype)`` stand-ins for the
    step's batch argument (not tensors),
  * ``n_micro`` — gradient-accumulation microbatches of a train cell,
  * the static extras (the decode cache length, graph sizes, the
    candidate count).

The shapes are the JAX package's, padding included: edge, triplet and
candidate counts rounded up to multiples of 512 (its 512-device mesh).
The JAX module picks DimeNet's triplet layout from the environment
(``REPRO_DENSE_TRIPLETS``) when it is imported; here it is
``cell_spec``'s ``dense_triplets`` keyword, with the same default.

``meta_batch`` turns a spec into ``meta`` tensors for the dry run's
abstract pass (``launch/dryrun.py``), ``random_batch`` into tensors of
valid random values on a device, and ``with_rows`` cuts a cell's batch
to fewer rows.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs import get_config, resolve_arch
from repro_torch.configs.base import (DimeNetConfig, RecSysConfig, ShapeSpec,
                                      TransformerConfig)
from repro_torch.device import dtype_of

i32, f32 = torch.int32, torch.float32


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """The shape and dtype of one batch entry (``jax.ShapeDtypeStruct``'s
    counterpart)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)


S = TensorSpec


def _pad512(n: int) -> int:
    return n + ((-n) % 512)


@dataclasses.dataclass(frozen=True)
class CellSpec:
    arch: str
    shape: str
    step_kind: str
    batch: Dict[str, Any]
    n_micro: int = 1
    # decode extras
    cache_len: int = 0
    # gnn extras
    n_nodes: int = 0
    n_edges: int = 0
    n_triplets: int = 0
    d_feat: int = 0
    n_graphs: int = 0
    # retrieval extras
    n_candidates: int = 0


# per-(arch, train shape) microbatch counts, the JAX package's
_N_MICRO = {
    ("llama3_2_3b", "train_4k"): 4,
    ("gemma2_27b", "train_4k"): 8,
    ("phi3_mini", "train_4k"): 4,
    ("moonshot_v1_16b", "train_4k"): 8,
    ("phi3_5_moe", "train_4k"): 8,
}


def _lm_cell(arch: str, cfg: TransformerConfig, spec: ShapeSpec) -> CellSpec:
    B, L = spec.global_batch, spec.seq_len
    if spec.kind == "train":
        pairs = max(1, B // 2)
        batch = {"q_tokens": S((pairs, L), i32), "q_mask": S((pairs, L), i32),
                 "d_tokens": S((pairs, L), i32), "d_mask": S((pairs, L), i32)}
        return CellSpec(arch, spec.name, "lsr_train", batch,
                        n_micro=_N_MICRO.get((arch, spec.name), 1))
    if spec.kind == "prefill":
        batch = {"tokens": S((B, L), i32), "mask": S((B, L), i32)}
        return CellSpec(arch, spec.name, "lsr_prefill", batch)
    if spec.kind == "decode":
        cache = S((cfg.n_layers, B, L, cfg.n_kv_heads, cfg.d_head),
                  dtype_of(cfg.compute_dtype))
        batch = {"tokens": S((B, 1), i32), "positions": S((B,), i32),
                 "cache_k": cache, "cache_v": cache}
        return CellSpec(arch, spec.name, "decode", batch, cache_len=L)
    raise ValueError(f"unknown LM shape kind {spec.kind}")


def _gnn_cell(arch: str, cfg: DimeNetConfig, spec: ShapeSpec,
              dense_triplets: bool) -> CellSpec:
    cap = cfg.max_triplets_per_edge

    if spec.kind == "batched_graphs":          # molecule
        n_graphs = spec.n_graphs
        N = _pad512(spec.n_nodes * n_graphs)
        E = _pad512(spec.n_edges * n_graphs)
        T = _pad512(E * 2)                     # exact triplets, avg deg ~2
        batch = {
            "positions": S((N, 3), f32),
            "node_feat": S((N,), i32),
            "node_mask": S((N,), i32),
            "node_graph_id": S((N,), i32),
            "edge_src": S((E,), i32), "edge_dst": S((E,), i32),
            "edge_mask": S((E,), i32),
            "t_in": S((T,), i32), "t_out": S((T,), i32),
            "t_mask": S((T,), i32),
            "target": S((n_graphs, cfg.n_targets), f32),
        }
        return CellSpec(arch, spec.name, "gnn_train", batch,
                        n_nodes=N, n_edges=E, n_triplets=T,
                        n_graphs=n_graphs)

    def triplet_specs(E: int) -> Dict[str, Any]:
        if dense_triplets and cap:
            return {"t_in_dense": S((E, cap), i32),
                    "t_mask_dense": S((E, cap), i32)}
        T = _pad512(E * max(1, cap))
        return {"t_in": S((T,), i32), "t_out": S((T,), i32),
                "t_mask": S((T,), i32)}

    if spec.kind == "minibatch":               # sampled training
        n_seed = spec.batch_nodes
        # per-hop edge budgets: seeds*f1, seeds*f1*f2 (fanout sampler)
        E_total = _pad512(n_seed * spec.fanout[0]
                          + n_seed * spec.fanout[0] * spec.fanout[1])
        N = _pad512(n_seed + E_total)
        T = _pad512(E_total * max(1, cap))
        d_feat = 602                           # Reddit feature width
        batch = {
            "positions": S((N, 3), f32),
            "node_feat": S((N, d_feat), f32),
            "node_mask": S((N,), i32),
            "edge_src": S((E_total,), i32), "edge_dst": S((E_total,), i32),
            "edge_mask": S((E_total,), i32),
            "seed_ids": S((n_seed,), i32),
            "target": S((n_seed, cfg.n_targets), f32),
            **triplet_specs(E_total),
        }
        return CellSpec(arch, spec.name, "gnn_train", batch,
                        n_nodes=N, n_edges=E_total, n_triplets=T,
                        d_feat=d_feat)

    # full graph (cora size and ogb-products size)
    N = _pad512(spec.n_nodes)
    E = _pad512(spec.n_edges)
    T = _pad512(E * max(1, cap))
    batch = {
        "positions": S((N, 3), f32),
        "node_feat": S((N, spec.d_feat), f32),
        "node_mask": S((N,), i32),
        "edge_src": S((E,), i32), "edge_dst": S((E,), i32),
        "edge_mask": S((E,), i32),
        "target": S((N, cfg.n_targets), f32),
        **triplet_specs(E),
    }
    return CellSpec(arch, spec.name, "gnn_train", batch,
                    n_nodes=N, n_edges=E, n_triplets=T, d_feat=spec.d_feat)


def _family_inputs(cfg: RecSysConfig, B: int) -> Dict[str, Any]:
    if cfg.interaction == "dot":
        return {"dense": S((B, cfg.n_dense), f32),
                "sparse_idx": S((B, cfg.n_sparse), i32)}
    if cfg.interaction == "augru":
        return {"hist_idx": S((B, cfg.seq_len), i32),
                "target_idx": S((B,), i32)}
    return {"sparse_idx": S((B, cfg.n_sparse), i32)}


def _recsys_cell(arch: str, cfg: RecSysConfig, spec: ShapeSpec) -> CellSpec:
    if spec.kind == "train":
        batch = _family_inputs(cfg, spec.batch)
        batch["label"] = S((spec.batch,), f32)
        return CellSpec(arch, spec.name, "recsys_train", batch)
    if spec.kind == "serve":
        return CellSpec(arch, spec.name, "recsys_serve",
                        _family_inputs(cfg, spec.batch))
    if spec.kind == "retrieval":
        NC = _pad512(spec.n_candidates)
        batch = _family_inputs(cfg, spec.batch)
        batch["candidates"] = S((NC, cfg.embed_dim), f32)
        return CellSpec(arch, spec.name, "retrieval", batch, n_candidates=NC)
    raise ValueError(f"unknown recsys shape kind {spec.kind}")


def cell_spec(arch_id: str, shape_name: str, *,
              dense_triplets: bool = True, smoke: bool = False) -> CellSpec:
    """The cell's ``CellSpec``; a skipped cell raises ``ValueError``.
    ``dense_triplets`` (the JAX package's ``REPRO_DENSE_TRIPLETS=1``, its
    default) gives DimeNet's capped-triplet cells the dense ``(E, K)``
    layout, else the flat one. ``smoke`` sizes the widths the batch
    depends on (caches, tables' features) by the arch's SMOKE config."""
    arch = resolve_arch(arch_id)
    mod = get_config(arch)
    cfg = mod.SMOKE if smoke else mod.CONFIG
    spec = mod.SHAPES[shape_name]
    if spec.skip:
        raise ValueError(
            f"cell ({arch_id}, {shape_name}) is skipped: {spec.skip_reason}")
    if isinstance(cfg, TransformerConfig):
        return _lm_cell(arch, cfg, spec)
    if isinstance(cfg, DimeNetConfig):
        return _gnn_cell(arch, cfg, spec, dense_triplets)
    if isinstance(cfg, RecSysConfig):
        return _recsys_cell(arch, cfg, spec)
    raise TypeError(f"unknown config type {type(cfg)}")


def with_rows(cell: CellSpec, rows: int, seq_len: int = 0,
              n_candidates: int = 0) -> CellSpec:
    """``cell`` with its batch cut (or grown) to ``rows`` rows: pairs of
    an LSR train cell, sequences of a prefill or decode cell (the caches'
    batch axis too), examples of a recsys cell; an LM cell's sequences
    (a decode cell's cache) also to ``seq_len``, a retrieval cell's
    candidates to ``n_candidates``, when given. A GNN cell has no rows
    to cut and raises."""
    if cell.step_kind == "gnn_train":
        raise ValueError(f"{cell.arch}/{cell.shape}: a graph cell has no "
                         "batch rows to cut")
    batch = {}
    for name, t in cell.batch.items():
        shape = (rows,) + tuple(t.shape[1:])
        if name == "candidates":
            shape = (n_candidates or t.shape[0], t.shape[1])
        elif name in ("cache_k", "cache_v"):
            shape = (t.shape[0], rows, seq_len or t.shape[2]) + t.shape[3:]
        elif seq_len and len(shape) == 2 and cell.step_kind in (
                "lsr_train", "lsr_prefill"):
            shape = (rows, seq_len)
        batch[name] = S(shape, t.dtype)
    decode = cell.step_kind == "decode"
    return dataclasses.replace(
        cell, batch=batch,
        cache_len=(seq_len or cell.cache_len) if decode else 0,
        n_candidates=n_candidates or cell.n_candidates)


def meta_batch(cell: CellSpec) -> Dict[str, torch.Tensor]:
    """The cell's batch as ``meta`` tensors: shapes and dtypes, no
    storage behind them."""
    return {name: torch.empty(t.shape, dtype=t.dtype, device="meta")
            for name, t in cell.batch.items()}


def _index_range(name: str, cell: CellSpec, cfg: Any, col: int) -> int:
    """How far the values of an index entry may range."""
    if name in ("q_tokens", "d_tokens", "tokens"):
        return cfg.vocab_size
    if name in ("edge_src", "edge_dst", "seed_ids"):
        return cell.n_nodes
    if name in ("t_in", "t_out", "t_in_dense"):
        return cell.n_edges
    if name == "node_feat":
        return cfg.n_atom_types
    if name == "sparse_idx":
        return cfg.table_sizes[col]
    if name in ("hist_idx", "target_idx"):
        return cfg.table_sizes[0]
    raise KeyError(name)


def random_batch(cell: CellSpec, cfg: Any, generator: torch.Generator,
                 device=None) -> Dict[str, torch.Tensor]:
    """The cell's batch as valid random tensors on ``device`` (default
    the generator's): ids within their ranges (tokens below V, table ids
    below each table's rows, node, edge and triplet ids below the cell's
    counts), masks all 1, a decode position at the cache's last slot,
    graph ids ascending, 0/1 labels, normal floats elsewhere; ``cfg``
    (the cell's config, or its SMOKE) gives the ranges. For measuring a
    step at a cell's shapes; the values mean nothing."""
    dev = generator.device if device is None else torch.device(device)

    def ints(high, shape):
        return torch.randint(0, high, shape, generator=generator, device=dev,
                             dtype=torch.int64).to(i32)

    out = {}
    for name, t in cell.batch.items():
        shape = tuple(t.shape)
        if name.endswith("mask") or name.endswith("mask_dense"):
            out[name] = torch.ones(shape, dtype=t.dtype, device=dev)
        elif name == "positions" and cell.step_kind == "decode":
            out[name] = torch.full(shape, cell.cache_len - 1, dtype=t.dtype,
                                   device=dev)
        elif name == "node_graph_id":
            out[name] = (torch.arange(shape[0], device=dev) * cell.n_graphs
                         // shape[0]).to(t.dtype)
        elif name == "label":
            out[name] = ints(2, shape).to(t.dtype)
        elif t.dtype == i32 and name == "sparse_idx":
            out[name] = torch.stack([ints(_index_range(name, cell, cfg, j),
                                          shape[:1])
                                     for j in range(shape[1])], dim=1)
        elif t.dtype == i32:
            out[name] = ints(_index_range(name, cell, cfg, 0), shape)
        else:
            out[name] = torch.randn(shape, generator=generator, device=dev,
                                    dtype=t.dtype)
    return out
