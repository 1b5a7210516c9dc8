"""Model zoo in PyTorch (port of the JAX package's ``models/``), backing the
five baseline configs (``BASELINE.json``):

- ``linear``   -- sklearn iris logistic regression (config 0)
- ``tabular``  -- decision forests, xgboost and the pyfunc tier (config 1)
- ``resnet``   -- ResNet-50 image classifier (config 2)
- ``bert``     -- BERT-base encoder classifier (config 3)
- ``llama``    -- Llama-2 decoder (config 4)

with ``common``, ``quantization``, ``sampling``, ``prng`` and the flavor
``registry``.  Submodules import on first use, as in the reference.
"""

from . import common

__all__ = ["common", "linear", "tabular", "resnet", "bert", "llama", "registry"]


def __getattr__(name):
    if name in __all__:
        import importlib

        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
