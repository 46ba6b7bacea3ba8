"""The plain reference the benchmark holds the program to: plain
PyTorch, importing neither JAX nor anything of the program."""
