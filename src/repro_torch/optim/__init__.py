"""Optimizers, schedules and gradient accumulation of the port."""
