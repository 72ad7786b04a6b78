"""Mixture-of-Experts FFN with sort-based capacity dispatch
(``repro/models/moe.py``).

The JAX package computes it in plain XLA, outside any Pallas kernel, and
so does the port, in plain PyTorch, step for step:

1. route: an f32 softmax over the expert logits, the top-k experts of
   each token (ties to the lowest expert id, as ``lax.top_k``) and their
   gates renormalised to sum to 1;
2. the Switch Transformer load-balance loss, ``E * sum_e f_e * p_e``;
3. the T*k (token, expert) assignments sorted stably by expert;
4. each assignment's rank within its expert; ranks >= the capacity
   ``C = max(1, int(capacity_factor * top_k * T / E))`` are dropped (C is
   per call: it follows the call's T);
5. the kept tokens scattered into an (E, C + 1, D) buffer whose row C is
   the dropped assignments' sacrificial slot, sliced off;
6. SwiGLU as three batched products over the stacked experts;
7. each kept assignment's row gathered back, weighted by its gate, and
   each token's k rows summed in a fixed order (ascending expert id, the
   order of the reference's ``segment_sum`` over the sorted assignments),
   with no atomics: the same bits run to run.

Every expert runs its product over its C rows at each call, so a decode
step (T = B rows, C = 1 at moonshot's B 4) still reads every expert's
weights, as the reference does. No step syncs with the host.

The expert-parallel form (``moe_ffn_local_experts``, inside a
``shard_map`` over a mesh) arrives with multi-GPU, ROADMAP Queue 1 item 10.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F


def capacity(T: int, n_experts: int, top_k: int,
             capacity_factor: float) -> int:
    """Rows each expert takes in a call over ``T`` tokens."""
    return max(1, int(capacity_factor * top_k * T / n_experts))


def route(x: torch.Tensor, router_w: torch.Tensor, top_k: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(probs (T, E) f32, gates (T, k) f32, experts (T, k) i64)``: the
    f32 router softmax and its top k, highest first, ties to the lowest
    expert id (a stable descending sort), the gates renormalised."""
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = vals[:, :top_k]
    gates = gates / gates.sum(dim=-1, keepdim=True)
    return probs, gates, idx[:, :top_k]


def moe_ffn(x: torch.Tensor, router_w: torch.Tensor, w_gate: torch.Tensor,
            w_up: torch.Tensor, w_down: torch.Tensor, *, top_k: int,
            capacity_factor: float = 1.25
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out (T, D) in x's dtype, aux_loss f32 scalar)`` for flattened
    tokens ``x`` (T, D), ``router_w`` (D, E) and the stacked experts'
    ``w_gate``/``w_up`` (E, D, F) and ``w_down`` (E, F, D), which are cast
    to x's dtype (a no-op on weights already in it)."""
    T, D = x.shape
    E = router_w.shape[1]
    C = capacity(T, E, top_k, capacity_factor)
    probs, gates, experts = route(x, router_w, top_k)

    flat_expert = experts.reshape(-1)                          # (T*k,)
    order = torch.argsort(flat_expert, stable=True)
    s_expert = flat_expert[order]
    s_token = order // top_k
    s_gate = gates.reshape(-1)[order]

    # each expert's first sorted position (the exclusive cumsum of its
    # count), then each assignment's rank within its expert
    ids = torch.arange(E, device=x.device)
    starts = torch.searchsorted(s_expert, ids)
    counts = torch.searchsorted(s_expert, ids, right=True) - starts
    me = probs.mean(dim=0)
    ce = counts.float() / T / top_k
    aux = E * (me * ce).sum()

    rank = torch.arange(T * top_k, device=x.device) - starts[s_expert]
    keep = rank < C
    slot = torch.where(keep, rank, C)
    buf = torch.zeros((E, C + 1, D), dtype=x.dtype, device=x.device)
    buf[s_expert, slot] = x[s_token]
    buf = buf[:, :C]                                           # (E, C, D)

    cd = x.dtype
    g = torch.bmm(buf, w_gate.to(cd))
    u = torch.bmm(buf, w_up.to(cd))
    y = torch.bmm(F.silu(g) * u, w_down.to(cd))                # (E, C, D)

    # a dropped assignment reads row 0 of its expert with a zero gate: the
    # reference reads a zero row, the same 0 contribution
    s_gate = torch.where(keep, s_gate, 0.0).to(cd)
    per_assign = y[s_expert, torch.where(keep, slot, 0)] * s_gate[:, None]

    # each token's k sorted positions in ascending order (= ascending
    # expert id), then a fixed-order sum of its k rows
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * top_k, device=x.device)
    pos = inv.view(T, top_k).sort(dim=1).values
    out = per_assign[pos[:, 0]]
    for j in range(1, top_k):
        out = out + per_assign[pos[:, j]]
    return out.to(x.dtype), aux


def init_moe_params(generator: torch.Generator, n_layers: int, d_model: int,
                    d_ff: int, n_experts: int,
                    dtype: torch.dtype = torch.float32
                    ) -> Dict[str, torch.Tensor]:
    """Random stacked expert weights on the generator's device, in the
    JAX package's layout and scales: ``router`` (L, D, E), ``w_gate`` and
    ``w_up`` (L, E, D, F), ``w_down`` (L, E, F, D)."""
    dev = generator.device

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, device=dev,
                           dtype=dtype).mul_(scale)

    sc_in, sc_ff = d_model ** -0.5, d_ff ** -0.5
    L, D, Fd, E = n_layers, d_model, d_ff, n_experts
    return {"router": normal((L, D, E), sc_in),
            "w_gate": normal((L, E, D, Fd), sc_in),
            "w_up": normal((L, E, D, Fd), sc_in),
            "w_down": normal((L, E, Fd, D), sc_ff)}
