"""Int8 gradient compression with error feedback for the data-parallel
all-reduce (``repro/optim/compression.py``).

Per-tensor symmetric scaling (max-abs / 127) keeps the quantizer cheap;
the error-feedback residual (Seide et al. / EF-SGD) carries each step's
quantization error into the next step's gradient.
``compressed_allreduce`` moves int8 on the wire: the flat gradient is
quantized, its chunks exchanged (``collectives.all_to_all``), each
rank's chunk summed dequantized in rank order, requantized and gathered
as int8 with f32 scales. The arithmetic is the JAX function's.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.tree import tree_leaves, tree_map

Tree = Any


def compress_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (f32/bf16) -> (int8 payload, f32 scale)."""
    x32 = x.float()
    scale = (x32.abs().max() / 127.0).clamp_min(1e-12)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def compress_tree(grads: Tree, residual: Optional[Tree]
                  ) -> Tuple[Tree, Tree, Tree]:
    """Error-feedback compression of a gradient tree: (quantized payloads,
    scales, new residuals)."""
    if residual is None:
        residual = tree_map(lambda g: torch.zeros(g.shape, device=g.device),
                            grads)

    def comp(g, r):
        corrected = g.float() + r
        q, s = compress_int8(corrected)
        return q, s, corrected - decompress_int8(q, s)

    out = tree_map(comp, grads, residual)
    return tuple(tree_map(lambda _, o: o[i], grads, out) for i in range(3))


def _flatten(grads: Tree) -> Tuple[torch.Tensor, Any]:
    """The leaves, in JAX's order, as one f32 vector, and what
    ``_unflatten`` needs to rebuild the tree."""
    leaves = tree_leaves(grads)
    flat = torch.cat([leaf.reshape(-1).float() for leaf in leaves])
    return flat, (grads, [leaf.shape for leaf in leaves])


def _unflatten(flat: torch.Tensor, spec) -> Tree:
    tree, shapes = spec
    pieces, off = {}, 0
    for leaf, shape in zip(tree_leaves(tree), shapes):
        n = leaf.numel()
        pieces[id(leaf)] = flat[off:off + n].reshape(shape)
        off += n
    return tree_map(lambda leaf: pieces[id(leaf)], tree)


def compressed_allreduce(
    grads: Tree,
    residual: Optional[torch.Tensor],
    axis_name,
    mesh,
) -> Tuple[Tree, torch.Tensor]:
    """The mean of ``grads`` over ``axis_name`` of ``mesh`` with an int8
    wire format:

      1. error-feedback int8-quantize the flattened gradient (padded to a
         multiple of the axis size),
      2. ``all_to_all`` the int8 chunks (each rank receives its chunk of
         every peer) and sum them dequantized, in rank order,
      3. requantize the reduced chunk to int8,
      4. gather the int8 chunks and their f32 scales; dequantize.

    ``residual`` is the flat f32 error-feedback buffer (None at the first
    call). Returns (mean grads tree, new residual)."""
    from repro_torch.collectives import all_gather, all_to_all
    from repro_torch.launch.mesh import axis_size

    n = axis_size(mesh, axis_name)
    flat, spec = _flatten(grads)
    size = flat.shape[0]
    flat_p = F.pad(flat, (0, (-size) % n))
    if residual is None:
        residual = torch.zeros_like(flat_p)

    corrected = flat_p + residual
    q, s = compress_int8(corrected)
    new_residual = corrected - decompress_int8(q, s)

    chunk = flat_p.shape[0] // n
    recv = all_to_all(q.reshape(n, chunk), axis_name, mesh)
    s_all = all_gather(s.reshape(1), axis_name, mesh)
    part = recv[0].float() * s_all[0]
    for i in range(1, n):
        part = part + recv[i].float() * s_all[i]
    part = part / n

    q2, s2 = compress_int8(part)
    q2_all = all_gather(q2.reshape(1, chunk), axis_name, mesh)
    s2_all = all_gather(s2.reshape(1), axis_name, mesh)
    mean_flat = (q2_all.float() * s2_all[:, None]).reshape(-1)[:size]
    return _unflatten(mean_flat, spec), new_residual
