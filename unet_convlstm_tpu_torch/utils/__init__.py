"""Weights carried over from the JAX package."""
