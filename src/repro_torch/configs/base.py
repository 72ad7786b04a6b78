"""Config dataclasses of the port (its own copies of ``repro/configs``).

Only the transformer family of the SPLADE encoders is here: the port's
first slice serves ``splade_bert``. Field names and defaults are the JAX
package's, so a config reads the same in both.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One measured input shape (the LM fields of the JAX ShapeSpec)."""

    name: str
    kind: str  # train | prefill | decode | serve
    seq_len: int = 0
    global_batch: int = 0


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    family: str  # "dense" | "moe" (the port runs "dense" only)
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
    # gemma-2 features (the port runs full attention only)
    sliding_window: Optional[int] = None
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
    # Head backend, resolved against the head_api registry by
    # ``head_spec()``: "jax" is the JAX package's alias for "sparton".
    head_impl: str = "jax"
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
        """Approximate parameter count (embeddings + trunk), dense family."""
        d, f, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab_size
        attn = d * self.n_heads * self.d_head * 2 \
            + d * self.n_kv_heads * self.d_head * 2
        trunk = L * (attn + 3 * d * f + 2 * d)
        return trunk + V * d * (1 if self.tie_embeddings else 2)
