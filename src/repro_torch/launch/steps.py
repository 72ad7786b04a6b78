"""The LSR train step, the LSR prefill and decode steps and the streaming
top-k (``repro/launch/steps.py``, unsharded).

``build_lsr_train_step(cfg, ...)`` returns ``step(state, batch) ->
(state, {"loss": ...})``: the encoder trunk and the config's Sparton head
on the query and the document tokens, the SPLADE loss, its gradients
(through K2 and K3 for ``head_impl="kernel"``, the default), averaged over
``n_micro`` chunks, then AdamW on the f32 master params. The state is
``{"params", "opt": {"mu", "nu"}, "step"}``, as the JAX package's.
``build_lsr_prefill_step`` encodes ``{"tokens", "mask"}`` through the
trunk (causal for a decoder, dense or MoE) and the config's head: the
paper's head on a decoder backbone, K1 for ``head_impl="kernel"``.
``build_decode_step`` takes one KV-cache step on ``{"tokens",
"positions", "cache_k", "cache_v"}``. The train step raises on an MoE
config (its objective adds the aux loss: decoder training, ROADMAP Queue
1 item 12b). ``streaming_topk`` is the JAX package's tile-by-tile top-k
over a dense candidate matrix, the counterpart of K6 built from plain
PyTorch.

Still to come: every ``mesh`` (the vocab-sharded step, the
expert-parallel MoE and ``streaming_topk``'s ``vary_axes``: multi-GPU,
ROADMAP Queue 1 item 10), the recsys train and serve steps with
``build_retrieval_step`` and the GNN step (models this port does not hold
yet); the MarginMSE term waits for a distillation data source and the
MoE aux loss term for decoder training (item 12b).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import TransformerConfig
from repro_torch.kernels._common import NEG_INF
from repro_torch.kernels.topk_score import merge_topk
from repro_torch.losses.contrastive import splade_loss
from repro_torch.models import transformer as tfm
from repro_torch.optim.accumulation import microbatch_grads
from repro_torch.optim.optimizers import adamw, apply_updates
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
    """``(params, batch) -> loss``: both sides encoded with the config's
    head, then the SPLADE objective. An MoE config raises (item 12b)."""
    if cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name}: training an MoE trunk (the objective's "
            "aux_weight * (aux_q + aux_d) term) is not ported yet: it "
            "arrives with decoder training, ROADMAP Queue 1 item 12b")

    def loss_fn(params, mb):
        yq = tfm.lsr_encode(params, cfg, mb["q_tokens"], mb["q_mask"])
        yd = tfm.lsr_encode(params, cfg, mb["d_tokens"], mb["d_mask"])
        return splade_loss(yq, yd, lambda_q=cfg.lambda_q,
                           lambda_d=cfg.lambda_d, l1_weight=cfg.l1_weight)
    return loss_fn


def build_lsr_train_step(
    cfg: TransformerConfig,
    *,
    n_micro: int = 1,
    lr: float = 2e-5,
    total_steps: int = 100_000,
) -> Callable[[State, Batch], Tuple[State, Dict[str, torch.Tensor]]]:
    """The step: peak ``lr`` after 1000 warm-up steps, then a cosine to
    ``total_steps``. It returns a new state and leaves the one it was
    given as it was, so a fault-tolerant runner can retry it. An MoE
    config raises (item 12b, ``lsr_loss``)."""
    opt = adamw(linear_warmup_cosine(lr, 1000, total_steps))
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


def _no_mesh(mesh: Any, what: str) -> None:
    if mesh is not None:
        raise NotImplementedError(
            f"{what}: a mesh (the vocab-sharded head, the sharded cache) is "
            "not ported yet: it arrives with multi-GPU, ROADMAP Queue 1 "
            "item 10")


def _encode_fn(cfg: TransformerConfig, mesh: Any, n_batch: int,
               unroll: bool = False
               ) -> Callable[[Any, torch.Tensor, torch.Tensor], torch.Tensor]:
    """``(params, tokens, mask) -> y (B, V)``: the trunk and the config's
    head (``head_api.make_head``). ``n_batch`` and ``unroll`` shape the JAX
    function's sharding and layer scan; eager PyTorch has neither. (The
    JAX function also returns the MoE aux loss, which only its train step
    reads; serving drops it there too.)"""
    from repro_torch.core.head_api import make_head

    _no_mesh(mesh, "_encode_fn")
    head = make_head(cfg.head_spec())

    def encode(params, tokens, mask):
        Hs = tfm.forward_hidden(params, cfg, tokens, mask)
        E, b = tfm.head_weights(params, cfg)
        return head(Hs, E.to(Hs.dtype), b, mask)
    return encode


def build_lsr_prefill_step(cfg: TransformerConfig, mesh: Any = None,
                           n_batch: int = 1, unroll: bool = False
                           ) -> Callable[[Any, Batch], torch.Tensor]:
    """``serve(params, {"tokens", "mask"}) -> y (B, V)``, without
    autograd."""
    encode = _encode_fn(cfg, mesh, n_batch, unroll)

    @torch.no_grad()
    def serve(params, batch: Batch) -> torch.Tensor:
        return encode(params, batch["tokens"], batch["mask"])
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


def init_state(arch_id: str, generator: torch.Generator, *,
               smoke: bool = False) -> State:
    """A fresh train state for a transformer arch: random params on the
    generator's device (``models.transformer.init_params``), zero AdamW
    moments, step 0."""
    mod = get_config(arch_id)
    cfg = mod.SMOKE if smoke else mod.CONFIG
    params = tfm.init_params(generator, cfg)
    return {"params": params, "opt": adamw(1e-4).init(params), "step": 0}


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
    device of ``q`` and ``C``. ``vary_axes`` marks the carry of a
    ``shard_map`` over sharded candidates in the JAX package; sharded
    candidates arrive with multi-GPU and it raises until then.
    """
    if vary_axes is not None:
        raise NotImplementedError(
            "streaming_topk: vary_axes (a shard_map over sharded "
            "candidates) is not ported yet: it arrives with multi-GPU, "
            "ROADMAP Queue 1 item 10")
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
