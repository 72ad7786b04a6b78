"""The LSR train step, the LSR prefill and decode steps, the GNN train
step, the recsys train, serve and retrieval steps and the streaming top-k
(``repro/launch/steps.py``, unsharded).

``build_lsr_train_step(cfg, ...)`` returns ``step(state, batch) ->
(state, {"loss": ...})``: the trunk (a bidirectional encoder, or a dense
or MoE causal decoder) and the config's Sparton head on the query and
the document tokens, the SPLADE loss plus ``aux_weight * (aux_q +
aux_d)``, the MoE trunk's load-balance loss of each side (0 for a dense
trunk), plus ``distill_weight`` times the MarginMSE term when the config
sets it and the batch holds ``neg_tokens``, ``neg_mask`` and
``teacher_margin``, its gradients (through K2 and K3 for
``head_impl="kernel"``, the default), averaged over ``n_micro`` chunks,
then AdamW on the master params in their own dtype (f32 for the SMOKE
configs, bf16 for the decoders' full CONFIGs). The state is
``{"params", "opt": {"mu", "nu"}, "step"}``, as the JAX package's.
``build_lsr_prefill_step`` encodes ``{"tokens", "mask"}`` through the
trunk (causal for a decoder, dense or MoE) and the config's head: the
paper's head on a decoder backbone, K1 for ``head_impl="kernel"``.
``build_decode_step`` takes one KV-cache step on ``{"tokens",
"positions", "cache_k", "cache_v"}``.

``build_recsys_train_step(cfg)`` trains a recsys model on the mean BCE
of its click logits with Adagrad (``{"params", "opt": {"acc"},
"step"}``); ``build_recsys_serve_step`` gives click probabilities;
``build_retrieval_step`` scores ``batch["candidates"]`` against
``models.recsys.user_embedding`` with ``streaming_topk``, the JAX
package's tile-by-tile top-k over a dense candidate matrix, the
counterpart of K6 built from plain PyTorch, so that the ``(B, N)`` score
matrix is never built.

``build_gnn_train_step(cfg, n_graphs=...)`` trains DimeNet
(``models.dimenet``) on an MSE with AdamW (``{"params", "opt": {"mu",
"nu"}, "step"}``): against per-graph targets of ``forward_graph`` when
``n_graphs`` is set, against the targets of ``batch["seed_ids"]``' nodes
when the batch holds them, else over the nodes weighted by
``node_mask``.

``build_step(arch_id, cell)`` builds the step of a dry-run cell
(``configs.specs.CellSpec``) on the config ``arch_config_for_cell``
gives.

With a ``launch.mesh.Mesh`` (``_encode_fn``, ``build_lsr_prefill_step``,
``build_lsr_train_step``) every rank is given the whole batch and runs
its rows of it (split over the batch axes ``launch.sharding.
batch_axes_for`` picks) through the trunk, replicated over ``model``,
and the vocab-sharded head (``core/sharded.py``). By default every rank
holds the whole state; ``build_lsr_train_step(cfg, mesh, param_specs=,
zero_specs=)`` holds it by ``launch.sharding``'s specs (a state cut by
``shard_state``): each rank keeps its block of each parameter and its
ZeRO block of each moment, gathers the parameters that ``model`` splits
on use, sums the gradients over the batch axes into its ZeRO blocks,
runs AdamW there and gathers the update back into its param blocks.
``build_gnn_train_step(cfg, shard_axes=, mesh=)`` runs DimeNet's
row-sharded path: every rank is given its row blocks of the batch
(``gnn_batch_block``), the loss is the whole batch's on every rank, and
the gradients are summed over the axes once, so every rank's state is
the same bytes. ``build_recsys_train_step(cfg, mesh=, param_specs=,
zero_specs=)`` trains the recsys models on a state held by
``recsys_param_specs``: every rank is given the whole batch and runs its
rows of it, each table is looked up by its spec
(``sparse.sharded_embedding.row_sharded_take``: whole, over ``model``,
or over ``model`` and the batch axes), and Adagrad runs on the ZeRO
blocks; ``build_recsys_serve_step(cfg, mesh, param_specs)`` serves on
such params, and ``build_retrieval_step(cfg, mesh)`` streams each rank's
row block of the candidates and merges the ranks' winners. Still to
come: the expert-parallel MoE (10f); the sharded decode cache and the
production meshes of ``build_step`` (10g; multi-GPU, ROADMAP Queue 1).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import dataclasses
import warnings

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import (DimeNetConfig, RecSysConfig,
                                      TransformerConfig)
from repro_torch.kernels._common import NEG_INF
from repro_torch.kernels.topk_score import merge_topk
from repro_torch.losses.contrastive import (gathered_infonce,
                                            l1_regularizer, margin_mse_loss,
                                            splade_loss)
from repro_torch.models import dimenet as dimenet_model
from repro_torch.models import recsys as recsys_model
from repro_torch.models import transformer as tfm
from repro_torch.optim.accumulation import microbatch_grads
from repro_torch.optim.optimizers import adagrad, adamw, apply_updates
from repro_torch.optim.schedules import linear_warmup_cosine
from repro_torch.tree import tree_leaves, tree_map

State = Dict[str, Any]
Batch = Dict[str, torch.Tensor]


def value_and_grad(loss_fn: Callable[[Any, Batch], torch.Tensor]
                   ) -> Callable[[Any, Batch], Tuple[torch.Tensor, Any]]:
    """``(params, batch) -> (loss, grads)``, the grads a tree like params
    (zeros for a leaf the loss does not reach), as ``jax.value_and_grad``."""
    def fn(params, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        leaves = tree_leaves(live)
        with torch.enable_grad():
            loss = loss_fn(live, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        by_id = {id(p): (torch.zeros_like(p) if g is None else g)
                 for p, g in zip(leaves, grads)}
        return loss.detach(), tree_map(lambda p: by_id[id(p)], live)
    return fn


def lsr_loss(cfg: TransformerConfig) -> Callable[[Any, Batch], torch.Tensor]:
    """``(params, batch) -> loss``: both sides encoded by ``_encode_fn``
    (the trunk and the config's head), then the SPLADE objective with
    ``aux_weight * (aux_q + aux_d)``, as the JAX step's unsharded
    objective. With ``cfg.distill_weight`` set and ``neg_tokens`` in the
    batch, the negatives are encoded too and ``distill_weight *
    margin_mse_loss(yq, yd, yn, teacher_margin)`` is added (their aux
    loss is not, as in the reference). An MoE micro-batch routes its own
    ``rows x S`` tokens, so its capacity follows the micro-batch."""
    encode = _encode_fn(cfg, None, 1)

    def loss_fn(params, mb):
        yq, aux_q = encode(params, mb["q_tokens"], mb["q_mask"])
        yd, aux_d = encode(params, mb["d_tokens"], mb["d_mask"])
        loss = splade_loss(yq, yd, lambda_q=cfg.lambda_q,
                           lambda_d=cfg.lambda_d, l1_weight=cfg.l1_weight,
                           aux_loss=aux_q + aux_d,
                           aux_weight=cfg.aux_weight)
        if cfg.distill_weight and "neg_tokens" in mb:
            yn, _ = encode(params, mb["neg_tokens"], mb["neg_mask"])
            loss = loss + cfg.distill_weight * margin_mse_loss(
                yq, yd, yn, mb["teacher_margin"])
        return loss
    return loss_fn


def sharded_lsr_loss(cfg: TransformerConfig, mesh: Any, n_pairs: int
                     ) -> Callable[[Any, Batch], torch.Tensor]:
    """``(params, batch) -> loss`` on a mesh: ``batch`` is the whole
    (micro-)batch of ``n_pairs`` pairs, and this rank encodes its rows
    (split over ``batch_axes_for(mesh, n_pairs)``). With the vocabulary
    divisible by ``model``, the objective is composed from the sharded
    primitives (``core/sharded.py``: InfoNCE, FLOPS, L1, MarginMSE's row
    dots), so the reps are never gathered; otherwise the head runs
    unsharded and the objective is the gathered one
    (``gathered_infonce`` and the regularizers' batch means averaged over
    the batch axes). Either way it is the unsharded ``lsr_loss`` of the
    whole batch, the same value on every rank; the MoE aux loss is
    averaged over the batch axes."""
    from repro_torch.collectives import pmean
    from repro_torch.core import sharded as sh
    from repro_torch.launch.sharding import batch_axes_for

    baxes = batch_axes_for(mesh, n_pairs)
    encode = _encode_fn(cfg, mesh, n_pairs)

    def batch_mean(x):
        return pmean(x, baxes, mesh) if baxes else x

    def cut(x):
        return sh.local_block(mesh, (baxes or None,), x)

    if cfg.vocab_size % mesh.shape["model"] == 0:
        infonce = sh.sharded_infonce(mesh, batch_axes=baxes)
        flops = sh.sharded_flops_reg(mesh, batch_axes=baxes)
        l1 = sh.sharded_l1_reg(mesh, batch_axes=baxes)
        row_dots = sh.sharded_row_dots(mesh, batch_axes=baxes)

        def margin_mse(yq, yd, yn, teacher):
            margin = row_dots(yq, yd) - row_dots(yq, yn)
            return batch_mean(((margin - teacher) ** 2).mean())
    else:
        def infonce(yq, yd):
            return gathered_infonce(yq, yd, axis_names=baxes, mesh=mesh)

        def flops(y):
            mean_act = batch_mean(y.float().abs().mean(dim=0))
            return (mean_act * mean_act).sum()

        def l1(y):
            return batch_mean(l1_regularizer(y))

        def margin_mse(yq, yd, yn, teacher):
            return batch_mean(margin_mse_loss(yq, yd, yn, teacher))

    def loss_fn(params, mb):
        mb = {k: cut(v) for k, v in mb.items()}
        yq, aux_q = encode(params, mb["q_tokens"], mb["q_mask"])
        yd, aux_d = encode(params, mb["d_tokens"], mb["d_mask"])
        loss = infonce(yq, yd)
        loss = loss + cfg.lambda_q * flops(yq) + cfg.lambda_d * flops(yd)
        if cfg.l1_weight:
            loss = loss + cfg.l1_weight * (l1(yq) + l1(yd))
        if cfg.distill_weight and "neg_tokens" in mb:
            yn, _ = encode(params, mb["neg_tokens"], mb["neg_mask"])
            loss = loss + cfg.distill_weight * margin_mse(
                yq, yd, yn, mb["teacher_margin"])
        return loss + cfg.aux_weight * batch_mean(aux_q + aux_d)
    return loss_fn


def _micro_pairs(batch: Batch, n_pairs: Optional[int], n_micro: int) -> int:
    """A micro-batch's pairs (a batch of other than ``n_pairs`` raises)."""
    pairs = batch["q_tokens"].shape[0]
    if n_pairs is not None and pairs != n_pairs:
        raise ValueError(f"build_lsr_train_step: a batch of {pairs} "
                         f"pairs, built for {n_pairs}")
    return max(1, pairs // n_micro)


def build_lsr_train_step(
    cfg: TransformerConfig,
    mesh: Any = None,
    *,
    n_micro: int = 1,
    n_pairs: Optional[int] = None,
    lr: float = 2e-5,
    total_steps: int = 100_000,
    param_specs: Any = None,
    zero_specs: Any = None,
) -> Callable[[State, Batch], Tuple[State, Dict[str, torch.Tensor]]]:
    """The step: peak ``lr`` after 1000 warm-up steps, then a cosine to
    ``total_steps``. It returns a new state and leaves the one it was
    given as it was, so a fault-tolerant runner can retry it.

    With a ``launch.mesh.Mesh`` every rank is given the whole batch (of
    ``n_pairs`` pairs, when given) and runs ``_mesh_step``: by default
    every rank holds the whole state and every parameter leaves the step
    the same bits on every rank; ``param_specs`` or ``zero_specs`` (spec
    trees like the params, ``launch.sharding``'s) hold the state by them
    instead. Either alone means what it means in the reference: no
    ``param_specs``, params whole; no ``zero_specs``, the moments at the
    param specs."""
    schedule = linear_warmup_cosine(lr, 1000, total_steps)
    if mesh is not None:
        return _mesh_step(cfg, mesh, schedule, n_micro=n_micro,
                          n_pairs=n_pairs, param_specs=param_specs,
                          zero_specs=zero_specs)
    if param_specs is not None or zero_specs is not None:
        raise ValueError("build_lsr_train_step: param_specs and "
                         "zero_specs place the state on a mesh; give "
                         "the mesh")
    opt = adamw(schedule)
    grad_fn = value_and_grad(lsr_loss(cfg))

    def step(state: State, batch: Batch):
        loss, grads = microbatch_grads(grad_fn, state["params"], batch,
                                       n_micro=n_micro)
        updates, opt_state = opt.update(grads, state["opt"],
                                        state["params"], state["step"])
        params = apply_updates(state["params"], updates)
        return ({"params": params, "opt": opt_state,
                 "step": state["step"] + 1}, {"loss": loss})

    return step


def _mesh_step(cfg: TransformerConfig, mesh: Any, schedule: Callable, *,
               n_micro: int, n_pairs: Optional[int], param_specs: Any,
               zero_specs: Any
               ) -> Callable[[State, Batch],
                             Tuple[State, Dict[str, torch.Tensor]]]:
    """The LSR step over a mesh on a state held by specs (the reference's
    ZeRO-2 under GSPMD, its collectives written out; no specs: the whole
    state on every rank). The state's params are this rank's blocks under
    ``param_specs``, its moments its blocks under ``zero_specs``
    (``launch.sharding.shard_state``). Each micro-batch: every leaf that a
    param spec splits (over ``model``: a spec that splits a parameter
    over a batch axis raises) is gathered on use with
    ``all_gather_invariant``, whose backward keeps this rank's block of
    the one cotangent (the tied E's head part arrives through the head's
    ``shard_rows``, gathered over ``model``, so it is counted once), and
    the loss is ``sharded_lsr_loss``'s. The gradients are summed over the
    batch axes into this rank's ZeRO blocks (``zero_reducer``): each
    micro-batch's as it comes where a ZeRO spec splits a leaf over a
    batch axis (the f32 accumulator then lives at the ZeRO block), else
    once, after the micro-batches are accumulated. AdamW runs on those
    blocks (the params cut to them, the clip's norm that of the whole
    gradient); the update is cast to the param dtype there and gathered
    into the param blocks. Every rank that holds a block holds the same
    bits."""
    from repro_torch.collectives import all_gather, all_gather_invariant
    from repro_torch.core.sharded import local_block
    from repro_torch.launch.mesh import batch_axes
    from repro_torch.launch.sharding import (batch_axes_for, map_specs,
                                             replicated, spec_axes,
                                             zero_extra)
    from repro_torch.optim.accumulation import zero_reducer

    baxes = batch_axes(mesh)
    plan: Dict[str, Any] = {}
    grad_fns: Dict[int, Any] = {}

    def check(pspec, zspec):
        split = [a for a in spec_axes(pspec) if a in baxes]
        if split:
            raise ValueError(f"build_lsr_train_step: a param spec {pspec} "
                             f"splits a parameter over the batch axes "
                             f"{split}; only non-batch axes (model) may")
        return zero_extra(pspec, zspec)

    def resolve(params):
        if not plan:
            pspecs = (param_specs if param_specs is not None else
                      tree_map(lambda p: replicated(p.ndim), params))
            zspecs = zero_specs if zero_specs is not None else pspecs
            plan.update(pspecs=pspecs, zspecs=zspecs,
                        extra=map_specs(check, pspecs, zspecs))
            zero_axes: set = set()
            map_specs(lambda ex: zero_axes.update(spec_axes(ex)),
                      plan["extra"])
            plan["per_micro"] = bool(zero_axes & set(baxes))
            plan["opt"] = adamw(
                schedule, mesh=mesh, block_axes=map_specs(spec_axes, zspecs),
                shard_fn=lambda ps: map_specs(
                    lambda ex, p: local_block(mesh, ex, p), plan["extra"],
                    ps))
        return plan

    def gather_on_use(blocks):
        def gather(pspec, x):
            for dim, axes in enumerate(pspec):
                if axes:
                    x = all_gather_invariant(x, axes, mesh, dim=dim)
            return x
        return map_specs(gather, plan["pspecs"], blocks)

    def to_param_block(extra, u, p):
        u = u.to(p.dtype)
        for dim, axes in enumerate(extra):
            if axes:
                u = all_gather(u, axes, mesh, dim=dim)
        return u

    def step(state: State, batch: Batch):
        resolve(state["params"])
        micro = _micro_pairs(batch, n_pairs, n_micro)
        if micro not in grad_fns:
            loss_fn = sharded_lsr_loss(cfg, mesh, micro)
            grad_fns[micro] = (
                value_and_grad(lambda blocks, mb: loss_fn(
                    gather_on_use(blocks), mb)),
                zero_reducer(mesh, plan["pspecs"], plan["zspecs"],
                             batch_axes_for(mesh, micro)))
        grad_fn, reduce = grad_fns[micro]
        per_micro = plan["per_micro"]
        loss, grads = microbatch_grads(grad_fn, state["params"], batch,
                                       n_micro=n_micro,
                                       reduce=reduce if per_micro else None)
        if not per_micro:
            grads = reduce(grads)
        updates, opt_state = plan["opt"].update(
            grads, state["opt"], state["params"], state["step"])
        del grads
        with torch.no_grad():
            updates = map_specs(to_param_block, plan["extra"], updates,
                                state["params"])
        params = apply_updates(state["params"], updates)
        return ({"params": params, "opt": opt_state,
                 "step": state["step"] + 1}, {"loss": loss})

    return step


def _no_mesh(mesh: Any, what: str,
             sharded: str = "the sharded cache, the expert-parallel MoE"
             ) -> None:
    if mesh is not None:
        raise NotImplementedError(
            f"{what}: a mesh ({sharded}) is not ported yet: it arrives "
            "with multi-GPU, ROADMAP Queue 1 item 10g")


def _encode_fn(cfg: TransformerConfig, mesh: Any, n_batch: int,
               unroll: bool = False
               ) -> Callable[[Any, torch.Tensor, torch.Tensor],
                             Tuple[torch.Tensor, torch.Tensor]]:
    """``(params, tokens, mask) -> (y (B, V), aux)``: the trunk and the
    config's head (``head_api.make_head``), and the MoE load-balance loss
    summed over the layers (an f32 scalar, 0 for a dense trunk), as the
    JAX function. ``unroll`` shapes the JAX function's layer scan; eager
    PyTorch has none.

    With a mesh, ``tokens`` and ``mask`` are this rank's rows of a batch
    of ``n_batch`` (split over ``batch_axes_for(mesh, n_batch)``), and
    ``y`` is this rank's block of the vocab-sharded head (``make_head``
    with the mesh). An MoE trunk keeps its dense dispatch on the rank's
    rows, with a warning: the expert-parallel MoE is not ported."""
    from repro_torch.core.head_api import make_head

    if mesh is None:
        head = make_head(cfg.head_spec())
    else:
        from repro_torch.launch.sharding import batch_axes_for

        if cfg.is_moe:
            warnings.warn(
                f"{cfg.name}: the expert-parallel MoE is not ported "
                "(ROADMAP item 10f): under a mesh each rank routes its own "
                "rows through the dense dispatch, with their own capacity "
                "and load-balance statistics")
        head = make_head(cfg.head_spec(), mesh,
                         batch_axes=batch_axes_for(mesh, n_batch))

    def encode(params, tokens, mask):
        Hs, aux = tfm.forward_hidden(params, cfg, tokens, mask,
                                     return_aux=True)
        E, b = tfm.head_weights(params, cfg)
        return head(Hs, E.to(Hs.dtype), b, mask), aux
    return encode


def build_lsr_prefill_step(cfg: TransformerConfig, mesh: Any = None,
                           n_batch: int = 1, unroll: bool = False
                           ) -> Callable[[Any, Batch], torch.Tensor]:
    """``serve(params, {"tokens", "mask"}) -> y (B, V)``, without
    autograd. With a mesh the batch is the whole one, of ``n_batch``
    rows, and ``y`` this rank's ``(B_local, V_local)`` block
    (``core.sharded.head_shardings``' ``"Y"`` with ``batch_axes_for(mesh,
    n_batch)``)."""
    encode = _encode_fn(cfg, mesh, n_batch, unroll)
    if mesh is not None:
        from repro_torch.core.sharded import local_block
        from repro_torch.launch.sharding import batch_spec

        rows = batch_spec(mesh, n_batch, 2)

    @torch.no_grad()
    def serve(params, batch: Batch) -> torch.Tensor:
        tokens, mask = batch["tokens"], batch["mask"]
        if mesh is not None:
            if tokens.shape[0] != n_batch:
                raise ValueError(f"build_lsr_prefill_step: a batch of "
                                 f"{tokens.shape[0]} rows, built for "
                                 f"{n_batch}")
            tokens = local_block(mesh, rows, tokens)
            mask = local_block(mesh, rows, mask)
        return encode(params, tokens, mask)[0]
    return serve


def build_decode_step(cfg: TransformerConfig, mesh: Any = None
                      ) -> Callable[[Any, Batch], Tuple[torch.Tensor, ...]]:
    """``serve(params, {"tokens" (B, 1), "positions" (B,), "cache_k",
    "cache_v"}) -> (logits (B, V), cache_k, cache_v)``, without autograd:
    ``models.transformer.decode_step``, which writes the caches in
    place."""
    _no_mesh(mesh, "build_decode_step")

    @torch.no_grad()
    def serve(params, batch: Batch):
        cache = {"k": batch["cache_k"], "v": batch["cache_v"]}
        logits, cache = tfm.decode_step(params, cfg, cache, batch["tokens"],
                                        batch["positions"])
        return logits, cache["k"], cache["v"]
    return serve


def bce_with_logits(logits: torch.Tensor,
                    label: torch.Tensor) -> torch.Tensor:
    """The mean BCE of click ``logits`` against 0/1 ``label``, written as
    the reference writes it: ``max(x, 0) - x * y + log1p(exp(-|x|))``
    (``max(x, 0)`` as ``relu``, whose gradient at ``x = 0`` is 0, as
    ``jnp.maximum(x, 0)``'s is)."""
    loss = torch.relu(logits) - logits * label \
        + torch.log1p(torch.exp(-logits.abs()))
    return loss.mean()


def build_recsys_train_step(
    cfg: RecSysConfig,
    *,
    lr: float = 1e-2,
    param_specs: Any = None,
    zero_specs: Any = None,
    mesh: Any = None,
) -> Callable[[State, Batch], Tuple[State, Dict[str, torch.Tensor]]]:
    """The CTR train step: ``bce_with_logits`` of
    ``models.recsys.forward``'s logits against ``batch["label"]``, its
    dense gradients (a table's is table-sized, as JAX's gradient of
    ``take`` is), then Adagrad at ``lr``. It returns a new state and
    leaves the given one intact (a fault-tolerant runner retries a step
    on it). With a ``launch.mesh.Mesh`` the state is held by
    ``param_specs`` and ``zero_specs`` (``_recsys_mesh_step``); either
    without a mesh raises."""
    if mesh is not None:
        return _recsys_mesh_step(cfg, mesh, adagrad(lr), param_specs,
                                 zero_specs)
    if param_specs is not None or zero_specs is not None:
        raise ValueError("build_recsys_train_step: param_specs and "
                         "zero_specs place the state on a mesh; give the "
                         "mesh")
    opt = adagrad(lr)
    grad_fn = value_and_grad(lambda params, batch: bce_with_logits(
        recsys_model.forward(params, cfg, batch), batch["label"]))

    def step(state: State, batch: Batch):
        loss, grads = grad_fn(state["params"], batch)
        updates, opt_state = opt.update(grads, state["opt"],
                                        state["params"], state["step"])
        del grads   # table-sized: free them before the new params exist
        params = apply_updates(state["params"], updates)
        return ({"params": params, "opt": opt_state,
                 "step": state["step"] + 1}, {"loss": loss})

    return step


def _recsys_specs(params: Any, param_specs: Any) -> Any:
    """``param_specs`` (whole leaves when None), checked: only a table may
    be split, and only by its rows."""
    from repro_torch.launch.sharding import replicated, spec_items

    specs = (param_specs if param_specs is not None else
             tree_map(lambda p: replicated(p.ndim), params))
    for name, spec in spec_items(specs).items():
        table = name.split("/")[0] in ("tables", "linear", "wide",
                                       "item_table")
        if any(spec[1:]) or (spec and spec[0] and not table):
            raise ValueError(f"recsys mesh step: the spec {spec} of {name} "
                             "splits more than a table's rows")
    return specs


def _recsys_lookup(mesh: Any, param_specs: Any,
                   batch_axes: Tuple[str, ...]) -> Callable:
    """``models.recsys``' ``lookup(path, table, idx)`` on this rank's table
    blocks: ``take_rows`` for a whole table, else ``row_sharded_take``
    over its spec's axes, ``idx`` this rank's rows of a batch split over
    ``batch_axes`` (``()``: the whole ids on every rank)."""
    from repro_torch.launch.sharding import spec_items
    from repro_torch.sparse.sharded_embedding import row_sharded_take

    specs = spec_items(param_specs)

    def lookup(path, table, idx):
        axes = specs[path][0]
        if not axes:
            return recsys_model.take_rows(table, idx)
        return row_sharded_take(table, idx, axes=axes, mesh=mesh,
                                batch_axes=batch_axes)
    return lookup


def _batch_rows(mesh: Any, batch: Batch) -> Tuple[Batch, Tuple[str, ...]]:
    """This rank's rows of a whole recsys batch (each entry's dim 0 over
    ``batch_axes_for(mesh, B)``) and those axes."""
    from repro_torch.core.sharded import local_block
    from repro_torch.launch.sharding import batch_axes_for

    n = next(iter(batch.values())).shape[0]
    split = batch_axes_for(mesh, n)
    return ({k: local_block(mesh, (split or None,), v)
             for k, v in batch.items()}, split)


def _recsys_mesh_step(cfg: RecSysConfig, mesh: Any, opt: Any,
                      param_specs: Any, zero_specs: Any
                      ) -> Callable[[State, Batch],
                                    Tuple[State, Dict[str, torch.Tensor]]]:
    """The recsys step over a mesh on a state held by specs (the
    reference's step under GSPMD on ``recsys_param_specs``, its
    collectives written out; no ``param_specs``: every leaf whole; no
    ``zero_specs``: the accumulators at the param specs). The state's
    params are this rank's blocks, its accumulators its ZeRO blocks
    (``launch.sharding.shard_state``). Every rank is given the whole
    batch and runs its rows (split over ``batch_axes_for``); each table
    is looked up by its spec (``_recsys_lookup``); the loss is the BCE
    mean over the whole batch, the same on every rank. The ranks of
    ``model`` run the same MLPs on the same rows, so nothing is summed
    over ``model`` but the lookups' partials. The gradients go to this
    rank's ZeRO blocks (``zero_reducer``; a table split over batch axes
    already holds the whole batch's gradient on its block), Adagrad runs
    there, and the update is gathered into the param blocks. Every rank
    that holds a block holds the same bits."""
    from repro_torch.collectives import all_gather, pmean
    from repro_torch.launch.sharding import map_specs, zero_extra
    from repro_torch.optim.accumulation import zero_reducer

    plan: Dict[str, Any] = {}
    grad_fns: Dict[Tuple[str, ...], Any] = {}

    def resolve(params, split):
        if not plan:
            pspecs = _recsys_specs(params, param_specs)
            zspecs = zero_specs if zero_specs is not None else pspecs
            plan.update(pspecs=pspecs, zspecs=zspecs,
                        extra=map_specs(zero_extra, pspecs, zspecs))
        if split not in grad_fns:
            lookup = _recsys_lookup(mesh, plan["pspecs"], split)

            def loss_fn(blocks, rows):
                loss = bce_with_logits(recsys_model.forward(
                    blocks, cfg, rows, lookup=lookup), rows["label"])
                return pmean(loss, split, mesh) if split else loss
            grad_fns[split] = (value_and_grad(loss_fn), zero_reducer(
                mesh, plan["pspecs"], plan["zspecs"], split))
        return grad_fns[split]

    def to_param_block(extra, u):
        for dim, axes in enumerate(extra):
            if axes:
                u = all_gather(u, axes, mesh, dim=dim)
        return u

    def step(state: State, batch: Batch):
        rows, split = _batch_rows(mesh, batch)
        grad_fn, reduce = resolve(state["params"], split)
        loss, grads = grad_fn(state["params"], rows)
        grads = reduce(grads)
        updates, opt_state = opt.update(grads, state["opt"],
                                        state["params"], state["step"])
        del grads
        with torch.no_grad():
            updates = map_specs(to_param_block, plan["extra"], updates)
        params = apply_updates(state["params"], updates)
        return ({"params": params, "opt": opt_state,
                 "step": state["step"] + 1}, {"loss": loss})

    return step


GNN_NODE_KEYS = ("positions", "node_feat", "node_mask", "node_graph_id")
GNN_EDGE_KEYS = ("edge_src", "edge_dst", "edge_mask", "t_in_dense",
                 "t_mask_dense")
GNN_TRIPLET_KEYS = ("t_in", "t_out", "t_mask")


def gnn_batch_block(batch: Dict[str, Any], mesh: Any,
                    shard_axes: Tuple[str, ...], *,
                    n_graphs: int = 0) -> Dict[str, Any]:
    """This rank's row block, over ``shard_axes``, of each node-, edge- and
    triplet-leading array of a whole DimeNet batch (``GNN_*_KEYS``, and a
    node-level ``target``: no ``n_graphs``, no ``seed_ids``), the others
    (``seed_ids``, a graph or seed ``target``) whole: what
    ``build_gnn_train_step(shard_axes=, mesh=)`` takes. Tensors or numpy
    arrays; a row count the shards do not divide raises ``ValueError``."""
    from repro_torch.launch.mesh import as_axes, axis_index, axis_size

    axes = as_axes(shard_axes)
    n, i = axis_size(mesh, axes), axis_index(mesh, axes)
    node_target = not n_graphs and "seed_ids" not in batch
    out = {}
    for key, v in batch.items():
        if key in GNN_NODE_KEYS + GNN_EDGE_KEYS + GNN_TRIPLET_KEYS \
                or (key == "target" and node_target):
            if v.shape[0] % n:
                raise ValueError(
                    f"gnn_batch_block: {key} has {v.shape[0]} rows, which "
                    f"{n} shards over {axes} do not divide")
            size = v.shape[0] // n
            v = v[i * size:(i + 1) * size]
        out[key] = v
    return out


def gnn_loss(cfg: DimeNetConfig, n_graphs: int = 0, *,
             shard_axes: Optional[Tuple[str, ...]] = None, mesh: Any = None
             ) -> Callable[[Any, Batch], torch.Tensor]:
    """``(params, batch) -> loss``, the reference's three branches: the
    mean squared error of ``forward_graph``'s ``n_graphs`` outputs when
    ``n_graphs`` is set; else of the outputs at ``batch["seed_ids"]``
    when the batch holds them; else the node errors weighted by
    ``node_mask``, summed over ``max(sum(node_mask), 1)``. With
    ``shard_axes`` and ``mesh`` the batch is this rank's blocks
    (``gnn_batch_block``) and the loss the whole batch's, the same on
    every rank: the graph outputs are summed over the axes, the node
    outputs gathered before the seeds are taken, the node errors and the
    mask summed over the axes."""
    from repro_torch.collectives import all_gather_invariant, psum

    axes = dimenet_model.resolve_shard_axes(shard_axes, mesh, "gnn_loss")

    def loss_fn(params, batch):
        if n_graphs:
            pred = dimenet_model.forward_graph(params, cfg, batch, n_graphs,
                                               axes, mesh=mesh)
            return torch.mean((pred - batch["target"]) ** 2)
        pred = dimenet_model.forward(params, cfg, batch, axes, mesh=mesh)
        if "seed_ids" in batch:
            if axes:
                pred = all_gather_invariant(pred, axes, mesh)
            pred = dimenet_model.take(pred, batch["seed_ids"])
            return torch.mean((pred - batch["target"]) ** 2)
        mask = batch["node_mask"]
        err = (pred - batch["target"]) * mask.to(pred.dtype)[:, None]
        num, den = torch.sum(err * err), mask.sum()
        if axes:
            num, den = psum(num, axes, mesh), psum(den, axes, mesh)
        return num / den.clamp_min(1).to(pred.dtype)
    return loss_fn


def build_gnn_train_step(
    cfg: DimeNetConfig,
    *,
    n_graphs: int = 0,
    lr: float = 1e-4,
    shard_axes: Optional[Tuple[str, ...]] = None,
    mesh: Any = None,
) -> Callable[[State, Batch], Tuple[State, Dict[str, torch.Tensor]]]:
    """DimeNet's train step: ``gnn_loss``'s gradients, then AdamW at a
    constant ``lr``. ``n_graphs`` is the reference's ``cell.n_graphs``
    (0: a node-level target). It returns a new state and leaves the one
    it was given intact (a fault-tolerant runner retries a step on it).
    With ``shard_axes`` and ``mesh`` (the reference's ``shard_axes``
    path) each rank is given its blocks of the batch
    (``gnn_batch_block``) and holds the whole state; each rank's gradient
    share is summed over the axes once (one all-reduce), so every rank
    takes the same step."""
    from repro_torch.collectives import psum

    axes = dimenet_model.resolve_shard_axes(shard_axes, mesh,
                                            "build_gnn_train_step")
    opt = adamw(lr)
    grad_fn = value_and_grad(gnn_loss(cfg, n_graphs, shard_axes=axes,
                                      mesh=mesh))

    def step(state: State, batch: Batch):
        loss, grads = grad_fn(state["params"], batch)
        if axes:
            with torch.no_grad():
                grads = tree_map(lambda g: psum(g, axes, mesh), grads)
        updates, opt_state = opt.update(grads, state["opt"],
                                        state["params"], state["step"])
        params = apply_updates(state["params"], updates)
        return ({"params": params, "opt": opt_state,
                 "step": state["step"] + 1}, {"loss": loss})

    return step


def build_recsys_serve_step(cfg: RecSysConfig, mesh: Any = None,
                            param_specs: Any = None
                            ) -> Callable[[Any, Batch], torch.Tensor]:
    """``serve(params, batch) -> (B,)`` click probabilities (the sigmoid of
    the logits), without autograd. With a mesh, ``params`` are this
    rank's blocks under ``param_specs`` (every leaf whole when None) and
    ``batch`` the whole batch: each rank runs its rows (split over
    ``batch_axes_for``), its tables looked up by their specs, and every
    rank returns the whole batch's probabilities."""
    if mesh is None:
        if param_specs is not None:
            raise ValueError("build_recsys_serve_step: param_specs place "
                             "the params on a mesh; give the mesh")

        @torch.no_grad()
        def serve(params, batch: Batch) -> torch.Tensor:
            return torch.sigmoid(recsys_model.forward(params, cfg, batch))
        return serve

    from repro_torch.collectives import all_gather

    @torch.no_grad()
    def serve_mesh(params, batch: Batch) -> torch.Tensor:
        rows, split = _batch_rows(mesh, batch)
        lookup = _recsys_lookup(mesh, _recsys_specs(params, param_specs),
                                split)
        p = torch.sigmoid(recsys_model.forward(params, cfg, rows,
                                               lookup=lookup))
        return all_gather(p, split, mesh) if split else p
    return serve_mesh


def build_retrieval_step(cfg: RecSysConfig, mesh: Any = None, *,
                         k: int = 100, param_specs: Any = None
                         ) -> Callable[[Any, Batch],
                                       Tuple[torch.Tensor, torch.Tensor]]:
    """``serve(params, batch) -> (vals (B, k) f32, idx (B, k) i32)``, without
    autograd: the query vectors of ``models.recsys.user_embedding``, then
    ``streaming_topk`` over ``batch["candidates"]`` ``(N, embed_dim)``
    (its default tile of 65536 rows): the ``(B, N)`` scores are never
    built.

    With a mesh (the reference's sharded body), the query inputs are whole
    on every rank, ``batch["candidates"]`` this rank's row block over
    every axis of the mesh (``launch.sharding.candidate_block``),
    ``params`` this rank's blocks
    under ``param_specs`` (every leaf whole when None; the tables that
    ``user_embedding`` reads are looked up by their specs on the whole
    ids). Each rank streams its block (``tile=min(65536, rows_local)``),
    adds its row offset to the ids (to the padding ids of a block shorter
    than k too, as the reference does), the ``(B, k)`` winners of every
    rank are gathered in rank order, which is id order, and re-top-k'd
    by ``merge_topk``: ties go to the lowest id. Every rank returns the
    same result."""
    if mesh is None:
        if param_specs is not None:
            raise ValueError("build_retrieval_step: param_specs place the "
                             "params on a mesh; give the mesh")

        @torch.no_grad()
        def serve(params, batch: Batch):
            qv = recsys_model.user_embedding(params, cfg, batch)
            return streaming_topk(qv, batch["candidates"], k=k)
        return serve

    from repro_torch.collectives import all_gather
    from repro_torch.launch.mesh import axis_index

    axes = tuple(mesh.axis_names)

    @torch.no_grad()
    def serve_mesh(params, batch: Batch):
        lookup = _recsys_lookup(mesh, _recsys_specs(params, param_specs), ())
        qv = recsys_model.user_embedding(params, cfg, batch, lookup=lookup)
        cand = batch["candidates"]
        rows_local = cand.shape[0]
        vals, idx = streaming_topk(qv, cand, k=k,
                                   tile=min(65536, rows_local),
                                   vary_axes=axes)
        idx = idx + axis_index(mesh, axes) * rows_local
        all_v = all_gather(vals, axes, mesh, dim=1)
        all_i = all_gather(idx, axes, mesh, dim=1)
        return merge_topk(all_v[:, :0], all_i[:, :0], all_v, all_i, k)
    return serve_mesh


def new_state(cfg: Any, generator: torch.Generator, *,
              device=None, mesh: Any = None, specs: Any = None) -> State:
    """A fresh train state for ``cfg``, random params on ``device``
    (default the generator's), step 0: a ``TransformerConfig``'s
    (``models.transformer``) or a ``DimeNetConfig``'s (``models.dimenet``)
    with zero AdamW moments, a ``RecSysConfig``'s (``models.recsys``) with
    Adagrad's accumulators at 0.1, as the reference's ``init_state`` lays
    them out. ``device="meta"`` with a CPU generator gives the state's
    shapes alone, allocating nothing (there is no meta generator). With
    ``mesh`` and ``specs`` (``launch.sharding.state_shardings``' tree) it
    is this rank's blocks of that state (``shard_state``): every rank
    draws the same global params from the same seed, cuts its blocks and
    fills the optimizer's slots at its blocks (no global slot is built).
    One of the two without the other raises."""
    if (mesh is None) != (specs is None):
        raise ValueError("new_state: mesh and specs go together (the specs "
                         "place the state on the mesh)")
    params = init_params(cfg, generator, device=device)
    opt = adagrad(1e-2) if isinstance(cfg, RecSysConfig) else adamw(1e-4)
    if specs is None:
        return {"params": params, "opt": opt.init(params), "step": 0}
    from repro_torch.launch.sharding import (map_specs, shard_state,
                                             zero_extra)

    params = shard_state(mesh, specs["params"], params)

    def cut(pspec, zspec, x):   # a slot's fill at the param block
        return shard_state(mesh, zero_extra(pspec, zspec), x)
    opt_state = {slot: map_specs(cut, specs["params"], specs["opt"][slot],
                                 tree)
                 for slot, tree in opt.init(params).items()}
    return {"params": params, "opt": opt_state, "step": 0}


def init_params(cfg: Any, generator: torch.Generator, *,
                device=None) -> Any:
    """Random params of ``cfg``'s model (``models.recsys``,
    ``models.dimenet`` or ``models.transformer``) on ``device`` (default
    the generator's): what a serve step takes."""
    if isinstance(cfg, RecSysConfig):
        return recsys_model.init_params(generator, cfg, device)
    if isinstance(cfg, DimeNetConfig):
        return dimenet_model.init_params(generator, cfg, device)
    return tfm.init_params(generator, cfg, device)


def init_state(arch_id: str, generator: torch.Generator, *,
               smoke: bool = False, device=None, mesh: Any = None,
               specs: Any = None) -> State:
    """``new_state`` of the arch's CONFIG (SMOKE with ``smoke``)."""
    mod = get_config(arch_id)
    return new_state(mod.SMOKE if smoke else mod.CONFIG, generator,
                     device=device, mesh=mesh, specs=specs)


def arch_config_for_cell(arch_id: str, cell: Any) -> Any:
    """The arch's CONFIG adapted to a cell: DimeNet's input width is a
    property of the shape (atom types, or node-feature vectors)."""
    cfg = get_config(arch_id).CONFIG
    if isinstance(cfg, DimeNetConfig) and cfg.d_feat != cell.d_feat:
        cfg = dataclasses.replace(cfg, d_feat=cell.d_feat)
    return cfg


def build_step(arch_id: str, cell: Any, mesh: Any = None) -> Callable:
    """The step a dry-run cell runs, on ``arch_config_for_cell``'s config:
    a train step ``(state, batch) -> (state, {"loss"})`` for the three
    ``*_train`` kinds, else a serve function ``(params, batch)``. A mesh
    raises (multi-GPU)."""
    return build_cell_step(arch_config_for_cell(arch_id, cell), cell, mesh)


def build_cell_step(cfg: Any, cell: Any, mesh: Any = None) -> Callable:
    """``build_step`` on a given config (a SMOKE one, say)."""
    _no_mesh(mesh, "build_step", "the production meshes")
    kind = cell.step_kind
    if kind == "lsr_train":
        return build_lsr_train_step(cfg, n_micro=cell.n_micro)
    if kind == "lsr_prefill":
        return build_lsr_prefill_step(cfg, mesh,
                                      cell.batch["tokens"].shape[0])
    if kind == "decode":
        return build_decode_step(cfg, mesh)
    if kind == "gnn_train":
        return build_gnn_train_step(cfg, n_graphs=cell.n_graphs)
    if kind == "recsys_train":
        return build_recsys_train_step(cfg)
    if kind == "recsys_serve":
        return build_recsys_serve_step(cfg)
    if kind == "retrieval":
        return build_retrieval_step(cfg, mesh)
    raise ValueError(f"unknown step kind {kind}")


def streaming_topk(q: torch.Tensor, C: torch.Tensor, *, k: int,
                   tile: int = 65536,
                   vary_axes: Optional[Tuple[str, ...]] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of ``q @ C^T`` one candidate tile at a time: ``(vals (B, k)
    f32, idx (B, k) i32)``, never the whole ``(B, N)`` score matrix.

    Each ``(B, tile)`` slice of scores is folded into the running top-k
    with ``merge_topk``, tiles in ascending order, so ties go to the
    lowest id; when ``k > N`` the tail holds ``(NEG_INF, 0)``, the initial
    carry. C is read in place: the last tile is short rather than padded,
    and only the tile in hand is cast to f32 (bf16 inputs give f32
    results). The products are f32 under the caller's matmul precision
    (on the card, cuBLAS f32 only while TF32 is off). It runs on the
    device of ``q`` and ``C``. ``vary_axes`` (the mesh axes over which the
    candidates are sharded, ``build_retrieval_step(cfg, mesh)``) marks the
    scan's carry as varying over them inside the JAX package's
    ``shard_map``; PyTorch has no varying-value types to mark, so it is
    taken and changes nothing.
    """
    del vary_axes
    if tile < 1:
        raise ValueError(f"streaming_topk: tile must be >= 1, got {tile}")
    B = q.shape[0]
    N = C.shape[0]
    vals = torch.full((B, k), NEG_INF, dtype=torch.float32, device=q.device)
    idx = torch.zeros((B, k), dtype=torch.int32, device=q.device)
    qf = q.float()
    lanes = torch.arange(tile, dtype=torch.int32, device=q.device)
    for lo in range(0, N, tile):
        c = C[lo:lo + tile].float()
        ids = (lanes[:c.shape[0]] + lo).expand(B, -1)
        vals, idx = merge_topk(vals, idx, qf @ c.T, ids, k)
    return vals, idx
