"""PyTorch / CUDA port of the ball*-tree constrained-NN system.

Mirrors the reference package `repro` module for module (see
ROADMAP.md) and imports nothing of it. Public entry points run on the
CUDA device unless the caller asks for the CPU (`device="cpu"`,
`StreamingConfig(device="cpu")`), where each kernel's plain PyTorch
version stands in for it.
"""
