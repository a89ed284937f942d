"""The plain reference of the benchmark's correctness checks: plain PyTorch
written from the published definitions, parts of it frozen from the port
(the files name their commit). Nothing here imports the program, JAX or the
JAX package."""
