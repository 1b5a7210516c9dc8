"""Helpers shared by the port's scripts (the port's counterpart of the
JAX package's ``utils/``, holding only what the port needs)."""
