"""One train step of the flagship names, ``unet`` and ``unet_tpu``, against
the JAX package's (CPU, float32), from the same seeded variables and uint8
batch: ``test_torch_core_members.check_train_step``. The data-parallel steps
of ``tests/test_torch_parallel.py`` are held against these single-device
steps.

Both are ill-conditioned in float32 at these sizes, so both are held in
the check's two parts: the port's float32 step against a float64 copy
replaying its ReLU signs and max-pool picks, and JAX's step against the
float64 copy on its own branches. ``unet`` at 32px: the port's own step lies
up to 1.9e-2 of a tensor's largest entry from a float64 run
(``down_convolution_3``, whose BatchNorms see 64 values a channel).
``unet_tpu`` at 128px (at 32px its 1x1 bottleneck reads 3-12%): held
directly against JAX at the 1e-2 bar, 68 of ``dec1.conv_op.3.weight``'s
589824 entries read up to 2.7 times it.
"""

import pytest
import torch

import test_torch_core_members as core

torch.set_num_threads(1)

FLAGSHIP = {"unet": ("unet", 32, {}), "unet_tpu": ("unet_tpu", 128, {})}


@pytest.mark.parametrize("key,conditioned", [("unet", True), ("unet_tpu", True)])
def test_train_step_matches_jax(key, conditioned):
    core.check_train_step(core.build_member(*FLAGSHIP[key]), conditioned)
