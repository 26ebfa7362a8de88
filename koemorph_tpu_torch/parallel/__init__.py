"""Batched decoding."""
