"""Cross-cutting helpers of the port (its counterpart of the JAX package's
``utils/``): the clocks, the ``MlflowModel`` spec (``config``), the SLO
classes of a journey trace, logging, tracing, timing and the compile cache.
Submodules are imported on use."""
