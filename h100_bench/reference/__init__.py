"""The plain reference that decides ``correct``: plain PyTorch, importing
neither JAX, nor the JAX package, nor anything of ``repro_torch``."""
