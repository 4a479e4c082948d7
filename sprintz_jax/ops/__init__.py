"""Vectorized JAX/XLA compute kernels for the device path."""
