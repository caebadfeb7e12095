"""unet_zoo_tpu_torch: the PyTorch/CUDA port of ``unet_zoo_tpu`` for NVIDIA
Hopper (H100).

Same registry surface as the JAX package (``create_model``, ``list_models``,
``get_model_config``), with NCHW tensors in ``channels_last`` memory. The
Pallas TPU kernels on a model's path become hand-written CUDA kernels
(``ops/kernels``). This package imports neither JAX nor ``unet_zoo_tpu``.
"""

__version__ = "0.1.0"

__all__ = ["__version__", "create_model", "get_model_config", "list_models"]


def __getattr__(name):
    # the registry is imported on first use, so that a process that only
    # loads an exported predictor (``import unet_zoo_tpu_torch.ops.kernels``)
    # imports no model code
    if name in ("create_model", "get_model_config", "list_models"):
        from unet_zoo_tpu_torch import models

        return getattr(models, name)
    raise AttributeError(f"module 'unet_zoo_tpu_torch' has no attribute {name!r}")
