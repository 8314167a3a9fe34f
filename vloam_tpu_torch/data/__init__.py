"""NumPy host data layer (no torch, no jax)."""
