"""Sparse reps, the inverted index and retrieval scoring."""
