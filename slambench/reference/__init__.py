"""The plain reference of the benchmark's correctness checks: plain PyTorch
written from the published definitions and frozen from the port at commit
27c9911. Nothing here imports the program, JAX or the JAX package."""
