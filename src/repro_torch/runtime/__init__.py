"""Serving runtime: the batching loop and OOM detection."""
