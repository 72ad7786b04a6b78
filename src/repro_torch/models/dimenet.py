"""DimeNet, the directional message-passing GNN [arXiv:2003.03123]
(``repro/models/dimenet.py``), in plain PyTorch over nested dicts and
lists of tensors, weights laid out for ``x @ w + b``.

Messages live on directed edges and are updated by aggregating over
(k -> j -> i) triplets with a joint radial x angular basis: a radial
Bessel basis with a polynomial envelope, a spherical (distance x angle)
basis on triplets, an embedding block, ``n_blocks`` interaction blocks
with an ``n_bilinear``-rank bilinear layer, and per-block output
projections summed into node outputs. Message passing is a gather
(``sparse.embedding_bag.embedding_lookup``, ``jnp.take``'s rule) and a
segment sum (``sparse.segment.segment_sum``), as in the reference, both
summing in one fixed order, so a step repeats bit for bit; no kernel of
the port is on this path.

Two triplet layouts: flat ``(t_in, t_out, t_mask)`` lists (``forward``),
and the dense ``(E, K)`` layout of capped triplets (``t_in_dense``,
``t_mask_dense``; ``forward_dense_triplets``), where the aggregation to
edges is a local sum over K. The bilinear contraction is written out
in the order that keeps it small (``torch.einsum`` has no path search
here): the dense path never builds the ``(E, K, b, d)`` array (5.5 GB at
minibatch_lg): it sums over K first (``(E, b, d)``, a batched product),
then does one ``(E, b * d) @ (b * d, d)`` product; the flat path takes
the ``(T, b * d)`` outer product of the basis and the gathered messages
into the same product.

``clip`` and ``maximum`` pass gradients as ``jnp.clip`` and
``jnp.maximum`` do: half to each side at an exact tie (``torch.clamp``
would pass all of it). Padded edges are not inert, as in the reference:
their messages are ``silu(b)``, and triplets over them carry a mask of 1
when ``build_triplets`` made them; the masks zero only the bases and the
node aggregation. Init draws from an explicit ``torch.Generator``; the
numbers differ from ``jax.random``'s (tests carry weights across with
``weights.state_from_jax``).

``shard_axes`` with ``mesh=`` (a ``launch.mesh.Mesh``) runs the
reference's row-sharded path on this rank's blocks: the caller passes
this rank's row block of every node-leading array (``positions``,
``node_feat``, ``node_mask``, ``node_graph_id``), edge-leading array
(``edge_*``, ``t_in_dense``, ``t_mask_dense``) and triplet-leading array
(``t_in``, ``t_out``, ``t_mask``), the ids in them global, as a
``shard_map`` body sees them (``launch.steps.gnn_batch_block`` cuts
them), and gets this rank's block of the node outputs. The dense layout
gathers and scatters rows through ``sparse.distributed`` (all-to-all,
capacity-capped: a request past an owner's capacity reads a zero row or
adds nothing, and, as in the reference, the dropped counts are not
returned; ``sparse.distributed.DROPS`` records them). The flat layout,
which the reference only marks with sharding constraints, gathers a
whole table (``collectives.all_gather``) before each take and keeps its
block of each segment sum (``collectives.psum_scatter``): the unsharded
arithmetic. ``forward_graph`` sums its blocks' readout over the axes.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.collectives import all_gather, psum, psum_scatter
from repro_torch.configs.base import DimeNetConfig
from repro_torch.device import dtype_of
from repro_torch.launch.mesh import Mesh, as_axes, axis_size
from repro_torch.sparse.distributed import (distributed_segment_sum_local,
                                            distributed_take_local)
from repro_torch.sparse.embedding_bag import embedding_lookup
from repro_torch.sparse.segment import segment_sum

Params = Dict[str, Any]
Batch = Dict[str, torch.Tensor]
# take(table, idx) and scatter(vals, idx, rows of this rank's output)
Take = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
Scatter = Callable[[torch.Tensor, torch.Tensor, int], torch.Tensor]


def take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, idx, axis=0)`` whose backward sums in one fixed
    order, as ``segment_sum`` does: a step's gradients repeat bit for
    bit."""
    return embedding_lookup(table, idx, reproducible=True)


# ---------------------------------------------------------------------------
# the reference's tie rule
# ---------------------------------------------------------------------------

def maximum(x: torch.Tensor, c: float) -> torch.Tensor:
    """``jnp.maximum(x, c)``: at ``x == c`` half the gradient reaches x
    (``torch.maximum`` splits a tie as JAX does)."""
    return torch.maximum(x, torch.tensor(c, dtype=x.dtype, device=x.device))


def minimum(x: torch.Tensor, c: float) -> torch.Tensor:
    return torch.minimum(x, torch.tensor(c, dtype=x.dtype, device=x.device))


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)`` = ``minimum(maximum(x, lo), hi)``, so x gets
    half the gradient at either bound."""
    return minimum(maximum(x, lo), hi)


# ---------------------------------------------------------------------------
# bases
# ---------------------------------------------------------------------------

def envelope(d_scaled: torch.Tensor, p: int) -> torch.Tensor:
    """Polynomial cutoff envelope u(d) from the paper (eq. 8)."""
    a = -(p + 1) * (p + 2) / 2
    b = p * (p + 2)
    c = -p * (p + 1) / 2
    e = (1.0 / maximum(d_scaled, 1e-9)
         + a * d_scaled ** (p - 1) + b * d_scaled ** p
         + c * d_scaled ** (p + 1))
    return torch.where(d_scaled < 1.0, e, 0.0)


def _orders(n: int, like: torch.Tensor, start: int) -> torch.Tensor:
    return torch.arange(start, start + n, dtype=torch.float32,
                        device=like.device)


def radial_basis(d: torch.Tensor, cfg: DimeNetConfig) -> torch.Tensor:
    """(E,) distances -> (E, n_radial) enveloped sin-Bessel basis."""
    ds = d / cfg.cutoff
    n = _orders(cfg.n_radial, d, 1)
    env = envelope(ds, cfg.envelope_exponent)
    return (env[:, None] * math.sqrt(2.0 / cfg.cutoff)
            * torch.sin(n[None, :] * math.pi * ds[:, None]))


def spherical_basis(d: torch.Tensor, angle: torch.Tensor,
                    cfg: DimeNetConfig) -> torch.Tensor:
    """(T,) in-edge distances + (T,) angles -> (T, n_sph * n_rad)."""
    ds = d / cfg.cutoff
    env = envelope(ds, cfg.envelope_exponent)
    n = _orders(cfg.n_radial, d, 1)
    rad = env[:, None] * torch.sin(n[None, :] * math.pi * ds[:, None])
    l_ = _orders(cfg.n_spherical, d, 0)
    ang = torch.cos(l_[None, :] * angle[:, None])
    return (rad[:, None, :] * ang[:, :, None]).reshape(
        d.shape[0], cfg.n_spherical * cfg.n_radial)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _normal(g: torch.Generator, shape: Sequence[int], scale: float,
            dtype: torch.dtype) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=g, dtype=dtype).mul_(scale)


def _dense(g: torch.Generator, din: int, dout: int,
           dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    return {"w": _normal(g, (din, dout), din ** -0.5, dtype),
            "b": torch.zeros((dout,), dtype=dtype)}


def _apply(layer: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    return x @ layer["w"] + layer["b"]


def init_params(g: torch.Generator, cfg: DimeNetConfig,
                device=None) -> Params:
    """Random params on ``device`` (default the generator's), the
    reference's tree: ``embed_nodes`` (an ``(n_atom_types, d)`` table when
    ``d_feat == 0``, else a ``{"w", "b"}`` layer), ``embed_rbf``,
    ``embed_msg``, ``out_final`` and ``blocks``, a list of ``n_blocks``
    dicts. ``device="meta"`` with a CPU generator gives the shapes alone
    (the dry run's state)."""
    with torch.device(g.device if device is None else device):
        return _init_params(g, cfg)


def _init_params(g: torch.Generator, cfg: DimeNetConfig) -> Params:
    dtype = dtype_of(cfg.param_dtype)
    d = cfg.d_hidden
    n_sbf = cfg.n_spherical * cfg.n_radial
    params: Params = {
        "embed_nodes": (
            _normal(g, (cfg.n_atom_types, d), 0.1, dtype)
            if cfg.d_feat == 0 else _dense(g, cfg.d_feat, d, dtype)),
        "embed_rbf": _dense(g, cfg.n_radial, d, dtype),
        "embed_msg": _dense(g, 3 * d, d, dtype),
        "blocks": [],
        "out_final": _dense(g, d, cfg.n_targets, dtype),
    }
    for _ in range(cfg.n_blocks):
        params["blocks"].append({
            "rbf_gate": _dense(g, cfg.n_radial, d, dtype),
            "sbf_proj": _dense(g, n_sbf, cfg.n_bilinear, dtype),
            "w_bilinear": _normal(g, (cfg.n_bilinear, d, d), d ** -0.5,
                                  dtype),
            "msg_in": _dense(g, d, d, dtype),
            "msg_out": _dense(g, 2 * d, d, dtype),
            "out_rbf": _dense(g, cfg.n_radial, d, dtype),
            "out_node": _dense(g, d, d, dtype),
        })
    return params


# ---------------------------------------------------------------------------
# row access: one device, or this rank's blocks over a mesh
# ---------------------------------------------------------------------------

def resolve_shard_axes(shard_axes: Optional[Tuple[str, ...]],
                       mesh: Optional[Mesh], what: str) -> Tuple[str, ...]:
    """The axes the rows are blocked over (``()``: unsharded, as for
    ``None``); ``shard_axes`` without a ``mesh`` raises ``ValueError``."""
    if not shard_axes:
        return ()
    if mesh is None:
        raise ValueError(f"{what}: shard_axes={tuple(shard_axes)} needs the "
                         "mesh= whose axes they name")
    return as_axes(shard_axes)


def _all_to_all_rows(axes: Tuple[str, ...],
                     mesh: Mesh) -> Tuple[Take, Scatter]:
    """The dense layout's row access: ``sparse.distributed``'s take and
    segment sum, their dropped counts discarded as the reference
    discards them."""
    def take_rows(table, idx):
        out, _ = distributed_take_local(table, idx.reshape(-1),
                                        axis_names=axes, mesh=mesh)
        return out.reshape(tuple(idx.shape) + (table.shape[1],))

    def scatter_rows(vals, idx, rows):
        return distributed_segment_sum_local(vals, idx, rows,
                                             axis_names=axes, mesh=mesh)[0]
    return take_rows, scatter_rows


def _gathered_rows(axes: Tuple[str, ...],
                   mesh: Mesh) -> Tuple[Take, Scatter]:
    """The flat layout's row access: the whole table gathered before a
    take, this rank's block kept of a segment sum over all rows."""
    n = axis_size(mesh, axes)

    def take_rows(table, idx):
        return take(all_gather(table, axes, mesh), idx)

    def scatter_rows(vals, idx, rows):
        return psum_scatter(segment_sum(vals, idx, rows * n), axes, mesh)
    return take_rows, scatter_rows


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1) + 1e-12)


def _angle(v_in: torch.Tensor, v_out: torch.Tensor,
           denom: torch.Tensor) -> torch.Tensor:
    cosang = torch.sum(v_in * v_out, dim=-1) / maximum(denom, 1e-9)
    return torch.arccos(clip(cosang, -1.0 + 1e-7, 1.0 - 1e-7))


def _geometry(batch: Batch, take_rows: Take = take
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Edge distances + triplet (in-edge distance, angle)."""
    pos = batch["positions"]
    vec = take_rows(pos, batch["edge_src"]) - take_rows(pos,
                                                        batch["edge_dst"])
    dist = _norm(vec)
    t_in, t_out = batch["t_in"], batch["t_out"]
    v_in = take_rows(vec, t_in)                # k - j (in-edge k->j)
    v_out = -take_rows(vec, t_out)             # i - j (out-edge j->i)
    d_in = take_rows(dist, t_in)
    return dist, d_in, _angle(v_in, v_out, d_in * _norm(v_out))


def _embed(params: Params, cfg: DimeNetConfig, batch: Batch,
           rbf: torch.Tensor, take_rows: Take = take) -> torch.Tensor:
    """The first edge messages m (E, d), from the node embedding."""
    if cfg.d_feat == 0:
        h = take(params["embed_nodes"], batch["node_feat"])
    else:
        h = F.silu(_apply(params["embed_nodes"], batch["node_feat"]))
    rbf_e = F.silu(_apply(params["embed_rbf"], rbf))
    return F.silu(_apply(params["embed_msg"], torch.cat(
        [take_rows(h, batch["edge_src"]), take_rows(h, batch["edge_dst"]),
         rbf_e], dim=-1)))


def _bilinear(z: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``(R, b, d)`` (the basis times the messages) by the ``(b, d, f)``
    weight: one ``(R, b * d) @ (b * d, f)`` product."""
    return z.reshape(z.shape[0], -1) @ w.reshape(-1, w.shape[-1])


def _update(blk: Params, m: torch.Tensor, agg: torch.Tensor,
            rbf: torch.Tensor, e_mask: torch.Tensor, dst: torch.Tensor,
            node_out: torch.Tensor, scatter_rows: Scatter = segment_sum
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A block's message update from its triplet aggregate, and its
    output to the nodes."""
    gate = F.silu(_apply(blk["rbf_gate"], rbf))
    upd = F.silu(_apply(blk["msg_out"], torch.cat([m * gate, agg], dim=-1)))
    m = m + upd
    contrib = m * F.silu(_apply(blk["out_rbf"], rbf))
    node_agg = scatter_rows(contrib * e_mask[:, None], dst,
                            node_out.shape[0])
    return m, node_out + F.silu(_apply(blk["out_node"], node_agg))


def forward_dense_triplets(
    params: Params, cfg: DimeNetConfig, batch: Batch,
    shard_axes: Optional[Tuple[str, ...]] = None, *,
    mesh: Optional[Mesh] = None,
) -> torch.Tensor:
    """Node outputs (N, n_targets) from the dense ``(E, K)`` triplet layout
    (``t_in_dense``, ``t_mask_dense``; short rows masked): the aggregation
    of triplets to edges is a local sum over K, no segment scatter. With
    ``shard_axes`` every row access across blocks (positions and node
    embeddings by ``edge_src``/``edge_dst``, edge rows by ``t_in_dense``,
    the edge-to-node sum) goes through ``sparse.distributed``; blocks run
    un-rematted, as in the reference (remat re-ran the exchanges)."""
    axes = resolve_shard_axes(shard_axes, mesh, "forward_dense_triplets")
    take_rows, scatter_rows = (_all_to_all_rows(axes, mesh) if axes
                               else (take, segment_sum))
    src, dst = batch["edge_src"], batch["edge_dst"]
    e_mask = batch["edge_mask"].float()
    tk_mask = batch["t_mask_dense"].float()                   # (E, K)
    t_in = batch["t_in_dense"]                                # (E, K)
    E, K = t_in.shape

    vec = (take_rows(batch["positions"], src)
           - take_rows(batch["positions"], dst))
    dist = _norm(vec)                                         # (E,)
    vec_in = take_rows(vec, t_in)                             # (E, K, 3)
    d_in = _norm(vec_in)
    angle = _angle(vec_in, -vec[:, None, :], d_in * dist[:, None])

    rbf = radial_basis(dist, cfg) * e_mask[:, None]
    sbf = spherical_basis(d_in.reshape(-1), angle.reshape(-1), cfg)
    sbf = sbf.reshape(E, K, -1) * tk_mask[..., None]          # (E, K, nsbf)

    m = _embed(params, cfg, batch, rbf, take_rows)
    node_out = torch.zeros((batch["node_mask"].shape[0], cfg.d_hidden),
                           dtype=m.dtype, device=m.device)
    for blk in params["blocks"]:
        x_kj = F.silu(_apply(blk["msg_in"], m))               # (E, d)
        x_t = take_rows(x_kj, t_in)                           # (E, K, d)
        s = _apply(blk["sbf_proj"], sbf) * tk_mask[..., None]  # (E, K, b)
        # the K-sum first: (E, b, K) @ (E, K, d) -> (E, b, d)
        agg = _bilinear(s.transpose(1, 2) @ x_t, blk["w_bilinear"])
        m, node_out = _update(blk, m, agg, rbf, e_mask, dst, node_out,
                              scatter_rows)
    return _apply(params["out_final"], node_out)


def forward(
    params: Params, cfg: DimeNetConfig, batch: Batch,
    shard_axes: Optional[Tuple[str, ...]] = None, *,
    mesh: Optional[Mesh] = None,
) -> torch.Tensor:
    """Node-level outputs (N, n_targets) from flat triplets (``t_in``,
    ``t_out``, ``t_mask``); a batch with ``t_in_dense`` goes to
    ``forward_dense_triplets``. With ``shard_axes`` the rows of every
    table are gathered over the axes before a take, and each segment sum
    keeps this rank's block of the whole sum."""
    axes = resolve_shard_axes(shard_axes, mesh, "forward")
    if "t_in_dense" in batch:
        return forward_dense_triplets(params, cfg, batch, axes, mesh=mesh)
    take_rows, scatter_rows = (_gathered_rows(axes, mesh) if axes
                               else (take, segment_sum))
    dst = batch["edge_dst"]
    e_mask = batch["edge_mask"].float()
    t_mask = batch["t_mask"].float()
    n_edges = dst.shape[0]

    dist, d_in, angle = _geometry(batch, take_rows)
    rbf = radial_basis(dist, cfg) * e_mask[:, None]
    sbf = spherical_basis(d_in, angle, cfg) * t_mask[:, None]

    m = _embed(params, cfg, batch, rbf, take_rows)
    node_out = torch.zeros((batch["node_mask"].shape[0], cfg.d_hidden),
                           dtype=m.dtype, device=m.device)
    t_in, t_out = batch["t_in"], batch["t_out"]
    for blk in params["blocks"]:
        x_kj = F.silu(_apply(blk["msg_in"], m))               # (E, d)
        x_t = take_rows(x_kj, t_in)                           # (T, d)
        s = _apply(blk["sbf_proj"], sbf)                      # (T, b)
        xt2 = _bilinear(s[:, :, None] * x_t[:, None, :], blk["w_bilinear"])
        agg = scatter_rows(xt2 * t_mask[:, None], t_out, n_edges)
        m, node_out = _update(blk, m, agg, rbf, e_mask, dst, node_out,
                              scatter_rows)
    return _apply(params["out_final"], node_out)              # (N, n_targets)


def forward_graph(
    params: Params, cfg: DimeNetConfig, batch: Batch, n_graphs: int,
    shard_axes: Optional[Tuple[str, ...]] = None, *,
    mesh: Optional[Mesh] = None,
) -> torch.Tensor:
    """Graph-level readout: node outputs summed per ``node_graph_id`` (with
    ``shard_axes``, this rank's nodes summed, then summed over the axes:
    every rank holds all ``n_graphs`` outputs)."""
    axes = resolve_shard_axes(shard_axes, mesh, "forward_graph")
    node_out = forward(params, cfg, batch, axes, mesh=mesh)
    node_out = node_out * batch["node_mask"].to(node_out.dtype)[:, None]
    out = segment_sum(node_out, batch["node_graph_id"], n_graphs)
    return psum(out, axes, mesh) if axes else out
