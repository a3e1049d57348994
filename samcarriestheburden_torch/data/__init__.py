"""Artifact stores of the port (the JAX package's h5 schemas)."""
