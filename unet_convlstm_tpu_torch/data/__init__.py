"""Datasets: Moving-MNIST with velocity (numpy only)."""
