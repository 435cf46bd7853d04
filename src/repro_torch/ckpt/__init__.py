"""Checkpoints: atomic, keep-K, readable by the reference."""
