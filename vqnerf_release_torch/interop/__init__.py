"""Conversion between the JAX package's parameter pytrees and the port's modules."""
