"""Frozen copies (commit 27c9911) of the generators of the benchmark's
inputs: the CylinderWorld renderer and HF-Net's self-supervised weights.
They import no module of the program, so a change to the port's scenes
changes no benchmark input."""
