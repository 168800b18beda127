"""The plain references the benchmark judges the port by: plain PyTorch that
imports neither JAX nor anything of the port, and takes nothing the port has
made except where a module says which one choice it is handed."""
