"""Emotion-frontend configuration (PyTorch port)."""
