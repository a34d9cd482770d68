"""Core types, config, errors and padding helpers (copied from the JAX package)."""
