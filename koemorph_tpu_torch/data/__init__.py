"""Audio file I/O (PyTorch port)."""
