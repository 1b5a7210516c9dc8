"""Serving: the continuous-batching generation engine, the inference engine
and dynamic batcher of the V2 predict path, the artifact loader,
Prometheus metrics and the HTTP server (port of the JAX package's
``server/``).  Submodules are imported on use; nothing here pulls in
torch's CUDA state at import."""
