"""The SPLADE encoder trunk: attention and the dense transformer."""
