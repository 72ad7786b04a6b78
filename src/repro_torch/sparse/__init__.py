"""The message-passing substrate of the port (``repro/sparse``): segment
reductions, embedding lookups and bags, DimeNet's triplets and the
fanout sampler on one device; the all-to-all take and segment sum of
row-sharded tables over a mesh (``distributed``); the row-sharded
embedding tables of the recsys models (``sharded_embedding``)."""

from repro_torch.sparse import sharded_embedding

__all__ = ["sharded_embedding"]
