"""Real-time streaming runtime (PyTorch port)."""
