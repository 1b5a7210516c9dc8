"""Serving: the continuous-batching generation engine, the native-artifact
loader and the ``/generate`` HTTP server (port of the JAX package's
``server/``).  Submodules are imported on use; nothing here pulls in
torch's CUDA state at import."""
