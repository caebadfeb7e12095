"""unet_zoo_tpu_torch: the PyTorch/CUDA port of ``unet_zoo_tpu`` for NVIDIA
Hopper (H100).

Same registry surface as the JAX package (``create_model``, ``list_models``,
``get_model_config``), with NCHW tensors in ``channels_last`` memory. The
Pallas TPU kernels on a model's path become hand-written CUDA kernels
(``ops/kernels``). This package imports neither JAX nor ``unet_zoo_tpu``.
"""

from unet_zoo_tpu_torch.models import create_model, get_model_config, list_models

__version__ = "0.1.0"

__all__ = ["__version__", "create_model", "get_model_config", "list_models"]
