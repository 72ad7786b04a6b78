"""The message-passing substrate of the port (``repro/sparse``, single
device): segment reductions, embedding lookups and bags, DimeNet's
triplets and the fanout sampler."""
