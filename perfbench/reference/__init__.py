"""The plain reference that decides ``correct``: the program's plain
PyTorch forms (its STFT, mel and eGeMAPS operators, F0, the dual-stream
model, the streaming step, the sequence loss), copied and frozen here so
that a later change to the program cannot move them, with every kernel
route replaced by its plain form. Nothing here imports the program or
JAX; nothing here runs a kernel or a CUDA graph."""
