"""Signal-processing operators (PyTorch): framing, spectra, the fused
log-mel frontend, F0 and eGeMAPS, and the CUDA kernels under them."""
