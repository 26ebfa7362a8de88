"""Signal-processing operators of the streaming step (PyTorch)."""
