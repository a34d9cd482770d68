"""Embedding providers (the hash provider in this slice)."""
