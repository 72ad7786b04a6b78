"""RecSys architectures (``repro/models/recsys.py``): DLRM, xDeepFM, DIEN
and Wide&Deep, in plain PyTorch over nested dicts and lists of tensors.

All four share one skeleton: large embedding tables (rows padded to
``ROW_PAD``), looked up per field, feeding a feature interaction and a
small MLP:

* **DLRM** (MLPerf config): dense features through a bottom MLP, dot
  products between every pair of (dense, sparse) embeddings, a top MLP.
* **xDeepFM**: the Compressed Interaction Network (CIN), outer-product
  feature maps compressed per layer, beside a plain DNN and a linear part.
* **DIEN**: a GRU over the user's behaviour sequence, then a second pass
  (AUGRU) whose update gate is scaled by attention against the target item.
* **Wide&Deep**: a wide linear part over the ids beside a deep MLP over
  the concatenated embeddings.

Lookups follow ``jnp.take``'s rule (``take_rows``,
``sparse.embedding_bag.embedding_lookup``): a negative id counts from the
end of the table, and an id still outside it reads a NaN row and gets no
gradient. Every table lookup goes through one function, ``lookup(path,
table, idx)``, that ``forward``, ``user_embedding`` and the family
forwards take (default ``take_rows``): ``path`` names the table in the
params tree (``"tables/3"``, ``"linear/0"``, ``"item_table"``), so that
the mesh steps of ``launch.steps`` look each table up by its spec
(``sparse.sharded_embedding.row_sharded_take``) on this rank's block.
A table's gradient is dense (table-sized), as JAX's gradient of ``take``
is, so an optimizer step touches every row.
The ``retrieval_cand`` shape does not run these stacks per candidate:
``user_embedding`` gives one query vector per row and
``launch.steps.build_retrieval_step`` streams the candidates through a
top-k. Init draws from an explicit ``torch.Generator``, on its device
unless ``init_params`` is given another; the numbers differ from
``jax.random``'s (tests carry weights across with
``weights.state_from_jax``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.configs.base import RecSysConfig
from repro_torch.device import dtype_of
from repro_torch.sparse.embedding_bag import embedding_lookup as take_rows
from repro_torch.sparse.embedding_bag import \
    multi_table_lookup as _lookup_all

Params = Dict[str, Any]
Batch = Dict[str, torch.Tensor]
# lookup(path, table, idx) -> rows: ``take_rows``' contract
Lookup = Callable[[str, torch.Tensor, torch.Tensor], torch.Tensor]

ROW_PAD = 4096  # table rows padded for 512-device row sharding


def padded_rows(rows: int) -> int:
    """Rows padded to a multiple of ``ROW_PAD`` (the sharding invariant)."""
    return rows + ((-rows) % ROW_PAD)


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------

def _normal(g: torch.Generator, shape: Sequence[int], scale: float,
            dtype: torch.dtype) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=g, dtype=dtype).mul_(scale)


def _mlp_init(g: torch.Generator, dims: Sequence[int],
              dtype: torch.dtype) -> List[Dict[str, torch.Tensor]]:
    return [{"w": _normal(g, (dims[i], dims[i + 1]), dims[i] ** -0.5, dtype),
             "b": torch.zeros((dims[i + 1],), dtype=dtype)}
            for i in range(len(dims) - 1)]


def _mlp_apply(layers, x: torch.Tensor, *,
               final_act: bool = False) -> torch.Tensor:
    for li, layer in enumerate(layers):
        x = x @ layer["w"] + layer["b"]
        if li < len(layers) - 1 or final_act:
            x = torch.relu(x)
    return x


def _default_lookup(path: str, table: torch.Tensor,
                    idx: torch.Tensor) -> torch.Tensor:
    return take_rows(table, idx)


def _lookup_fields(lookup: Optional[Lookup], params: Params, name: str,
                   idx: torch.Tensor) -> torch.Tensor:
    """One id per field, one table per field (``params[name]``, a list of
    ``(rows_f, dim)``) through ``lookup``: ``(batch, n_fields, dim)``;
    with the default, ``_lookup_all``'s."""
    lookup = lookup or _default_lookup
    return torch.stack([lookup(f"{name}/{f}", t, idx[:, f])
                        for f, t in enumerate(params[name])], dim=1)


def _embed_init(g: torch.Generator, rows_per_table: Sequence[int], dim: int,
                dtype: torch.dtype) -> List[torch.Tensor]:
    return [_normal(g, (padded_rows(rows), dim), dim ** -0.5, dtype)
            for rows in rows_per_table]


# ---------------------------------------------------------------------------
# DLRM
# ---------------------------------------------------------------------------

def init_dlrm(g: torch.Generator, cfg: RecSysConfig) -> Params:
    dtype = dtype_of(cfg.param_dtype)
    d = cfg.embed_dim
    # interaction: pairwise dots among (1 bottom-mlp output + n_sparse)
    n_f = cfg.n_sparse + 1
    top_in = d + n_f * (n_f - 1) // 2
    return {
        "tables": _embed_init(g, cfg.table_sizes, d, dtype),
        "bot_mlp": _mlp_init(g, cfg.bot_mlp, dtype),
        "top_mlp": _mlp_init(g, (top_in,) + tuple(cfg.top_mlp), dtype),
    }


def dlrm_forward(params: Params, cfg: RecSysConfig, dense: torch.Tensor,
                 sparse_idx: torch.Tensor, *,
                 lookup: Optional[Lookup] = None) -> torch.Tensor:
    """dense (B, n_dense) f32, sparse_idx (B, n_sparse) -> (B,) logit."""
    x_bot = _mlp_apply(params["bot_mlp"], dense, final_act=True)  # (B, d)
    emb = _lookup_fields(lookup, params, "tables", sparse_idx)    # (B, F, d)
    feats = torch.cat([x_bot[:, None, :], emb], dim=1)            # (B, F+1, d)
    inter = torch.bmm(feats, feats.transpose(1, 2))         # (B, F+1, F+1)
    # the upper triangle without the diagonal, row-major as
    # jnp.triu_indices: the order top_mlp's first layer reads
    n_f = feats.shape[1]
    iu, ju = torch.triu_indices(n_f, n_f, offset=1, device=feats.device)
    top_in = torch.cat([x_bot, inter[:, iu, ju]], dim=-1)
    return _mlp_apply(params["top_mlp"], top_in)[:, 0]


# ---------------------------------------------------------------------------
# xDeepFM
# ---------------------------------------------------------------------------

def init_xdeepfm(g: torch.Generator, cfg: RecSysConfig) -> Params:
    dtype = dtype_of(cfg.param_dtype)
    m, d = cfg.n_sparse, cfg.embed_dim
    cin_w = []
    h_prev = m
    for h_k in cfg.cin_layers:
        cin_w.append(_normal(g, (h_prev * m, h_k), (h_prev * m) ** -0.5,
                             dtype))
        h_prev = h_k
    return {
        "tables": _embed_init(g, cfg.table_sizes, d, dtype),
        "linear": _embed_init(g, cfg.table_sizes, 1, dtype),
        "cin": cin_w,
        "dnn": _mlp_init(g, (m * d,) + tuple(cfg.mlp), dtype),
        "out": _mlp_init(g, (cfg.mlp[-1] + sum(cfg.cin_layers) + 1, 1),
                         dtype),
    }


def xdeepfm_forward(params: Params, cfg: RecSysConfig,
                    sparse_idx: torch.Tensor, *,
                    lookup: Optional[Lookup] = None) -> torch.Tensor:
    """sparse_idx (B, m) -> (B,) logit.

    CIN: ``x^k[b, h, d] = sum_{i,j} W^k[i*m + j, h] x^{k-1}[b, i, d]
    x^0[b, j, d]``. The reference forms ``z[b, i*m + j, d]`` and contracts
    it with ``W^k``; here ``z`` is formed as ``(B, d, i, j)``, the same
    products, so that the contraction over ``p = i*m + j`` is one GEMM on
    a view, with no transposed copy of ``z`` (20 GB per 200-wide layer at
    B 65536 and m 39)."""
    B = sparse_idx.shape[0]
    m, d = cfg.n_sparse, cfg.embed_dim
    x0 = _lookup_fields(lookup, params, "tables", sparse_idx)   # (B, m, d)
    lin = _lookup_fields(lookup, params, "linear", sparse_idx)  # (B, m, 1)
    lin_term = lin.sum(dim=(1, 2))[:, None]                 # (B, 1)

    x0_t = x0.transpose(1, 2)                               # (B, d, m)
    xs_t = x0_t
    pooled = []
    for w in params["cin"]:
        h_prev = xs_t.shape[2]
        z = xs_t[:, :, :, None] * x0_t[:, :, None, :]       # (B, d, h, m)
        xs_t = (z.reshape(B * d, h_prev * m) @ w).view(B, d, -1)
        del z   # without autograd, the next layer's z need not meet this one
        pooled.append(xs_t.sum(dim=1))                      # (B, h_k)
    cin_out = torch.cat(pooled, dim=-1)

    dnn_out = _mlp_apply(params["dnn"], x0.reshape(B, m * d),
                         final_act=True)
    final_in = torch.cat([dnn_out, cin_out, lin_term], dim=-1)
    return _mlp_apply(params["out"], final_in)[:, 0]


# ---------------------------------------------------------------------------
# DIEN
# ---------------------------------------------------------------------------

def _gru_init(g: torch.Generator, d_in: int, d_h: int,
              dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    return {"w": _normal(g, (d_in, 3 * d_h), d_in ** -0.5, dtype),
            "u": _normal(g, (d_h, 3 * d_h), d_h ** -0.5, dtype),
            "b": torch.zeros((3 * d_h,), dtype=dtype)}


def _gru_cell(p, x, h, update_gate_scale=None):
    """The standard GRU cell; AUGRU scales the update gate by attention."""
    gx = x @ p["w"] + p["b"]
    gh = h @ p["u"]
    rx, zx, nx = gx.chunk(3, dim=-1)
    rh, zh, nh = gh.chunk(3, dim=-1)
    r = torch.sigmoid(rx + rh)
    z = torch.sigmoid(zx + zh)
    if update_gate_scale is not None:
        z = z * update_gate_scale[:, None]
    n = torch.tanh(nx + r * nh)
    return (1 - z) * n + z * h


def init_dien(g: torch.Generator, cfg: RecSysConfig) -> Params:
    dtype = dtype_of(cfg.param_dtype)
    d, gd = cfg.embed_dim, cfg.gru_dim
    # the behaviour sequence and the target item share one item table
    return {
        "item_table": _normal(g, (padded_rows(cfg.table_sizes[0]), d),
                              d ** -0.5, dtype),
        "gru1": _gru_init(g, d, gd, dtype),
        "augru": _gru_init(g, gd, gd, dtype),
        "att": _mlp_init(g, (2 * gd, 36, 1), dtype),
        "item_proj": _mlp_init(g, (d, gd), dtype),
        "mlp": _mlp_init(g, (2 * gd + d,) + tuple(cfg.mlp) + (1,), dtype),
    }


def dien_forward(params: Params, cfg: RecSysConfig, hist_idx: torch.Tensor,
                 target_idx: torch.Tensor, unroll: int = 1, *,
                 lookup: Optional[Lookup] = None) -> torch.Tensor:
    """hist_idx (B, T) behaviour ids, target_idx (B,) -> (B,) logit.

    The reference's two ``lax.scan``s are loops over T; ``unroll`` (the
    scans' unroll factor in the reference, for cost probes) changes
    nothing here."""
    B, T = hist_idx.shape
    lookup = lookup or _default_lookup
    table = params["item_table"]
    hist = lookup("item_table", table, hist_idx)             # (B, T, d)
    tgt = lookup("item_table", table, target_idx)            # (B, d)
    tgt_h = _mlp_apply(params["item_proj"], tgt)             # (B, g)

    # interest extraction: a GRU over the sequence
    h = hist.new_zeros((B, cfg.gru_dim))
    states = []
    for t in range(T):
        h = _gru_cell(params["gru1"], hist[:, t], h)
        states.append(h)
    seq_h = torch.stack(states, dim=1)                       # (B, T, g)

    # interest evolution: attention against the target gates the AUGRU
    att_in = torch.cat([seq_h, tgt_h[:, None, :].expand_as(seq_h)], dim=-1)
    att = _mlp_apply(params["att"], att_in)[..., 0]          # (B, T)
    att = torch.softmax(att, dim=-1)
    h = hist.new_zeros((B, cfg.gru_dim))
    for t in range(T):
        h = _gru_cell(params["augru"], seq_h[:, t], h,
                      update_gate_scale=1.0 - att[:, t])

    mlp_in = torch.cat([h, tgt_h, tgt], dim=-1)
    return _mlp_apply(params["mlp"], mlp_in)[:, 0]


# ---------------------------------------------------------------------------
# Wide & Deep
# ---------------------------------------------------------------------------

def init_wide_deep(g: torch.Generator, cfg: RecSysConfig) -> Params:
    dtype = dtype_of(cfg.param_dtype)
    m, d = cfg.n_sparse, cfg.embed_dim
    return {
        "tables": _embed_init(g, cfg.table_sizes, d, dtype),
        "wide": _embed_init(g, cfg.table_sizes, 1, dtype),
        "deep": _mlp_init(g, (m * d,) + tuple(cfg.mlp) + (1,), dtype),
    }


def wide_deep_forward(params: Params, cfg: RecSysConfig,
                      sparse_idx: torch.Tensor, *,
                      lookup: Optional[Lookup] = None) -> torch.Tensor:
    B = sparse_idx.shape[0]
    m, d = cfg.n_sparse, cfg.embed_dim
    emb = _lookup_fields(lookup, params, "tables", sparse_idx)   # (B, m, d)
    wide = _lookup_fields(lookup, params, "wide", sparse_idx)    # (B, m, 1)
    deep = _mlp_apply(params["deep"], emb.reshape(B, m * d))
    return deep[:, 0] + wide.sum(dim=(1, 2))


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

INIT_FNS = {
    "dot": init_dlrm,
    "cin": init_xdeepfm,
    "augru": init_dien,
    "concat": init_wide_deep,
}


def init_params(generator: torch.Generator, cfg: RecSysConfig,
                device=None) -> Params:
    """Random weights of ``cfg``'s family on ``device`` (default the
    generator's), in the JAX package's layout (lists of tables, lists of
    ``{"w", "b"}`` layers). ``device="meta"`` with a CPU generator gives
    the shapes alone (the dry run's state). The family's builders create
    their tensors on the default device this sets."""
    with torch.device(generator.device if device is None else device):
        return INIT_FNS[cfg.interaction](generator, cfg)


def forward(params: Params, cfg: RecSysConfig, batch: Batch,
            unroll: int = 1, *, lookup: Optional[Lookup] = None
            ) -> torch.Tensor:
    """The (B,) logits; ``batch`` holds the family's inputs (``dense`` and
    ``sparse_idx``, ``sparse_idx``, or ``hist_idx`` and ``target_idx``).
    ``lookup(path, table, idx)`` reads every table (default
    ``take_rows``)."""
    if cfg.interaction == "dot":
        return dlrm_forward(params, cfg, batch["dense"], batch["sparse_idx"],
                            lookup=lookup)
    if cfg.interaction == "cin":
        return xdeepfm_forward(params, cfg, batch["sparse_idx"],
                               lookup=lookup)
    if cfg.interaction == "augru":
        return dien_forward(params, cfg, batch["hist_idx"],
                            batch["target_idx"], unroll=unroll, lookup=lookup)
    if cfg.interaction == "concat":
        return wide_deep_forward(params, cfg, batch["sparse_idx"],
                                 lookup=lookup)
    raise ValueError(f"unknown interaction {cfg.interaction!r}")


def user_embedding(params: Params, cfg: RecSysConfig, batch: Batch, *,
                   lookup: Optional[Lookup] = None) -> torch.Tensor:
    """The (B, embed_dim) query vector of the ``retrieval_cand`` shape:
    DLRM's bottom MLP, DIEN's mean behaviour embedding, else the mean of
    the field embeddings (``lookup`` as in ``forward``). The candidates
    are scored by a top-k over them, never through the interaction
    stack."""
    if cfg.interaction == "dot":
        return _mlp_apply(params["bot_mlp"], batch["dense"], final_act=True)
    if cfg.interaction == "augru":
        lookup = lookup or _default_lookup
        return lookup("item_table", params["item_table"],
                      batch["hist_idx"]).mean(dim=1)
    return _lookup_fields(lookup, params, "tables",
                          batch["sparse_idx"]).mean(dim=1)
