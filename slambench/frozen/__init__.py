"""Frozen copies of the generators of the benchmark's inputs: the
CylinderWorld renderer and HF-Net's self-supervised weights (commit
27c9911), and the loop circuit's landmark ring and synthetic features
(commit 0d99d19). They import no module of the program, so a change to the
port's scenes changes no benchmark input."""
