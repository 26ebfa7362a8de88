"""Dual-stream decoder modules (PyTorch)."""
