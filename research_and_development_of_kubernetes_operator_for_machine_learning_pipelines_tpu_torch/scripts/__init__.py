"""Runnable probes of the port, each the counterpart of a JAX script in
the repository's ``scripts/`` (run as ``python -m <port>.scripts.<name>``)."""
