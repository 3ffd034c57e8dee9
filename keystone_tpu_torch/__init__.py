"""keystone_tpu_torch — the PyTorch/CUDA port of ``keystone_tpu``.

Module paths and class names follow the JAX package, so each port module
sits where its counterpart does. The JAX package stays the reference;
the port imports ``torch``, numpy and scipy, never ``jax`` and never
``keystone_tpu``. Entry points run on the CUDA device unless the caller
passes ``device="cpu"`` (:func:`keystone_tpu_torch.device.resolve_device`).

Top-level exports resolve lazily (PEP 562), as in ``keystone_tpu``.
"""

from typing import Any

__version__ = "0.1.0"

_EXPORTS = {
    "ArrayDataset": "keystone_tpu_torch.data.dataset",
    "Dataset": "keystone_tpu_torch.data.dataset",
    "ObjectDataset": "keystone_tpu_torch.data.dataset",
    "Transformer": "keystone_tpu_torch.workflow.pipeline",
    "BatchTransformer": "keystone_tpu_torch.workflow.pipeline",
    "Estimator": "keystone_tpu_torch.workflow.pipeline",
    "LabelEstimator": "keystone_tpu_torch.workflow.pipeline",
    "Pipeline": "keystone_tpu_torch.workflow.pipeline",
    "FittedPipeline": "keystone_tpu_torch.workflow.pipeline",
    "resolve_device": "keystone_tpu_torch.device",
}

__all__ = sorted(_EXPORTS) + ["__version__"]


def __getattr__(name: str) -> Any:
    if name in _EXPORTS:
        import importlib

        module = importlib.import_module(_EXPORTS[name])
        value = getattr(module, name)
        globals()[name] = value  # cache for subsequent lookups
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return __all__
