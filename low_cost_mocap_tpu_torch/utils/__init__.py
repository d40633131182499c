"""Helpers: synthetic scenes and conversion from the JAX package's arrays."""
