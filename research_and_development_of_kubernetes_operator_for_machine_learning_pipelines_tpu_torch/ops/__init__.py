"""Hand-written Hopper kernels, each beside its plain PyTorch version.

A wrapper runs the plain version for a CPU tensor and launches its
kernel (or raises) for a CUDA tensor; each module (``decode_attention``,
``rmsnorm``, ``flash_attention``, ``sample_step``) counts its launches in
a plain integer ``launches``.  The modules are not re-exported here so that
``ops.rmsnorm`` stays the module that holds the counter."""
