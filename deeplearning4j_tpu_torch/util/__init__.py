"""Checkpoint serialization."""
