"""Training objectives of the port."""
