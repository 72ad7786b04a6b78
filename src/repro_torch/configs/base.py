"""Config dataclasses of the port (its own copies of ``repro/configs``).

The transformer family (the SPLADE encoders ``splade_bert`` and
``splade_xlmr``, the dense decoders ``llama3_2_3b``, ``gemma2_27b``,
``phi3_mini`` and the MoE decoders ``moonshot_v1_16b``, ``phi3_5_moe``),
the recsys family (``dlrm_mlperf``, ``xdeepfm``, ``dien``,
``wide_deep``) and the GNN family (``dimenet``). Field names and defaults
are the JAX package's, so a config reads the same in both, with one
exception:
``head_impl`` defaults to ``"kernel"``, the CUDA head, so that no entry
point serves or trains through a plain head unless it is asked to (CPU
tensors take the kernels' plain versions inside their wrappers).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One measured input shape (the JAX ShapeSpec's fields)."""

    name: str
    # train | prefill | decode | full_graph | minibatch | batched_graphs
    # | serve | retrieval
    kind: str
    # LM shapes
    seq_len: int = 0
    global_batch: int = 0
    # GNN shapes
    n_nodes: int = 0
    n_edges: int = 0
    d_feat: int = 0
    batch_nodes: int = 0
    fanout: Tuple[int, ...] = ()
    n_graphs: int = 0
    # recsys shapes
    batch: int = 0
    n_candidates: int = 0
    skip: bool = False
    skip_reason: str = ""


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    family: str  # "dense" | "moe"
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # gemma-2 features
    sliding_window: Optional[int] = None   # local attention window
    local_global_alternating: bool = False  # even layers local, odd global
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    # common
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    bidirectional_encoder: bool = False  # SPLADE-style encoders
    # execution
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True             # recompute each layer in the backward
    # LSR objective weights (losses.contrastive.splade_loss)
    lambda_q: float = 5e-4         # FLOPS weight on query reps
    lambda_d: float = 3e-4         # FLOPS weight on doc reps
    l1_weight: float = 0.0         # optional L1 on both rep sides
    aux_weight: float = 1e-2       # MoE load-balance aux weight
    distill_weight: float = 0.0    # MarginMSE weight (needs distill batch)
    # Head backend, resolved against the head_api registry by
    # ``head_spec()``: "jax" is the JAX package's alias for the plain
    # "sparton" head.
    head_impl: str = "kernel"
    # TPU tiles of the JAX package's Pallas head. None = let the kernel
    # choose; the CUDA kernel picks its own tiles and refuses pins.
    head_block_b: Optional[int] = None
    head_block_s: Optional[int] = None
    head_block_v: Optional[int] = None
    head_vocab_tile: int = 4096    # plain streaming tile
    # Rep sparsification, applied to the (B, V) head output on the device
    # by encoders built with head_api.make_encoder. Both None = dense.
    rep_topk: Optional[int] = None
    rep_threshold: Optional[float] = None
    rep_max_nnz: int = 256         # threshold-only slot budget
    attn_chunk: int = 512          # KV chunk size (online softmax)

    def head_spec(self, **overrides):
        """The config's head as a ``HeadSpec`` for ``make_head``."""
        from repro_torch.core.head_api import HeadSpec

        spec = HeadSpec(
            impl=self.head_impl,
            block_b=self.head_block_b,
            block_s=self.head_block_s,
            block_v=self.head_block_v,
            vocab_tile=self.head_vocab_tile,
            logit_softcap=self.final_logit_softcap,
            rep_topk=self.rep_topk,
            rep_threshold=self.rep_threshold,
            rep_max_nnz=self.rep_max_nnz,
        )
        if overrides:
            spec = spec.replace(**overrides)
        if spec.impl == "jax":
            spec = spec.replace(impl="sparton")
        return spec

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def n_params(self) -> int:
        """Approximate parameter count (embeddings + trunk + head)."""
        d, f, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab_size
        if self.is_moe:
            mlp = self.n_experts * 3 * d * f + d * self.n_experts
        else:
            mlp = 3 * d * f
        trunk = L * (self._attn_params + mlp + 2 * d)
        return trunk + V * d * (1 if self.tie_embeddings else 2)

    @property
    def n_active_params(self) -> int:
        """Active parameters per token (MoE counts top_k experts)."""
        if not self.is_moe:
            return self.n_params
        d, f, L = self.d_model, self.d_ff, self.n_layers
        mlp = self.top_k * 3 * d * f + d * self.n_experts
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return L * (self._attn_params + mlp + 2 * d) + embed

    @property
    def _attn_params(self) -> int:
        d = self.d_model
        return d * self.n_heads * self.d_head * 2 \
            + d * self.n_kv_heads * self.d_head * 2


def shapes_lm(long_ok: bool, long_skip_reason: str = "") -> Dict[str, ShapeSpec]:
    """The LM families' four shapes (the JAX package's ``shapes_lm``)."""
    return {
        "train_4k": ShapeSpec("train_4k", "train", seq_len=4096,
                              global_batch=256),
        "prefill_32k": ShapeSpec("prefill_32k", "prefill", seq_len=32768,
                                 global_batch=32),
        "decode_32k": ShapeSpec("decode_32k", "decode", seq_len=32768,
                                global_batch=128),
        "long_500k": ShapeSpec(
            "long_500k", "decode", seq_len=524288, global_batch=1,
            skip=not long_ok, skip_reason=long_skip_reason,
        ),
    }


@dataclasses.dataclass(frozen=True)
class DimeNetConfig:
    name: str
    family: str = "gnn"
    n_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    d_feat: int = 0                 # input node features (0 => atom types)
    n_atom_types: int = 95
    cutoff: float = 5.0
    envelope_exponent: int = 5
    max_triplets_per_edge: int = 0  # 0 => exact triplets
    n_targets: int = 1
    param_dtype: str = "float32"
    compute_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class RecSysConfig:
    name: str
    family: str = "recsys"
    interaction: str = "dot"  # dot | cin | augru | concat
    n_dense: int = 0
    n_sparse: int = 26
    embed_dim: int = 128
    table_sizes: Tuple[int, ...] = ()
    bot_mlp: Tuple[int, ...] = ()
    top_mlp: Tuple[int, ...] = ()
    mlp: Tuple[int, ...] = ()
    cin_layers: Tuple[int, ...] = ()
    # DIEN
    seq_len: int = 0
    gru_dim: int = 0
    param_dtype: str = "float32"
    compute_dtype: str = "float32"

    @property
    def total_rows(self) -> int:
        return sum(self.table_sizes)


SHAPES_GNN: Dict[str, ShapeSpec] = {
    "full_graph_sm": ShapeSpec("full_graph_sm", "full_graph",
                               n_nodes=2708, n_edges=10556, d_feat=1433),
    "minibatch_lg": ShapeSpec("minibatch_lg", "minibatch",
                              n_nodes=232965, n_edges=114615892,
                              batch_nodes=1024, fanout=(15, 10)),
    "ogb_products": ShapeSpec("ogb_products", "full_graph",
                              n_nodes=2449029, n_edges=61859140, d_feat=100),
    "molecule": ShapeSpec("molecule", "batched_graphs",
                          n_nodes=30, n_edges=64, n_graphs=128),
}

SHAPES_RECSYS: Dict[str, ShapeSpec] = {
    "train_batch": ShapeSpec("train_batch", "train", batch=65536),
    "serve_p99": ShapeSpec("serve_p99", "serve", batch=512),
    "serve_bulk": ShapeSpec("serve_bulk", "serve", batch=262144),
    "retrieval_cand": ShapeSpec("retrieval_cand", "retrieval", batch=1,
                                n_candidates=1_000_000),
}
