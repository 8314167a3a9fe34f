"""Solvers, searches and the hand-written CUDA kernels' wrappers."""
