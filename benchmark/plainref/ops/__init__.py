"""Solvers and searches (the kernel wrappers cut down to their plain versions)."""
