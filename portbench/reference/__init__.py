"""Plain references, one module per model: plain PyTorch, importing
nothing of the program or of JAX."""
