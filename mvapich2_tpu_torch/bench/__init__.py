"""Benches of the port (counterparts of the JAX package's ``bench/``)."""
