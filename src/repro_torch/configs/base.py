"""Config dataclasses of the port (its own copies of ``repro/configs``).

Only the transformer family is here: the port serves and trains the
SPLADE encoders (``splade_bert``, ``splade_xlmr``) and serves the dense
decoders (``llama3_2_3b``, ``gemma2_27b``, ``phi3_mini``) and the MoE
decoders (``moonshot_v1_16b``, ``phi3_5_moe``). Field names and
defaults are the JAX package's, so a config reads the same in both, with
one exception:
``head_impl`` defaults to ``"kernel"``, the CUDA head, so that no entry
point serves or trains through a plain head unless it is asked to (CPU
tensors take the kernels' plain versions inside their wrappers).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One measured input shape (the LM fields of the JAX ShapeSpec)."""

    name: str
    kind: str  # train | prefill | decode | serve
    seq_len: int = 0
    global_batch: int = 0
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
