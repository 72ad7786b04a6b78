"""Synthetic data of the port."""
