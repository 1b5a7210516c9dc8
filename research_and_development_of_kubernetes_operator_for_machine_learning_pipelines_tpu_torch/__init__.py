"""PyTorch/CUDA port of the JAX package's Llama text-generation path, its
V2 predict path (BERT, ResNet-50, linear models, decision forests and
xgboost, the pyfunc tier) and the canary path of its control plane.

Mirrors the layout of
``research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu``
(``ops/``, ``models/``, ``server/``) with the same function names, so each
port module sits at the same relative path as its reference:

- ``ops``     -- hand-written Hopper kernels (``csrc/*.cu``, built with
  nvcc and loaded with ctypes) beside their plain PyTorch versions;
- ``models``  -- Llama (int8 weights, dense and int8 ragged KV caches),
  BERT (float or int8 x int8 encoder matmuls), ResNet, linear and tabular
  models, the flavor registry, quantization and sampling;
- ``server``  -- the continuous-batching engine, the inference engine and
  dynamic batcher, the artifact loader, Prometheus metrics and a
  standard-library HTTP server for ``/generate``,
  ``/v2/models/{name}/infer`` and the Seldon routes;
- ``clients`` -- the operator's client protocols, fakes, the native canary
  router (``native/router.cc``, built with g++) and the local plane of live
  servers behind it;
- ``operator`` -- the ``MlflowModel`` reconciler (``backend: seldon`` and
  ``backend: cuda``), its judge, journal, autoscaler and runtime;
- ``convert`` -- carries a JAX parameter tree (as numpy) across.

The package imports torch and numpy only.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
