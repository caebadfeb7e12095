"""Packaging (ref: setup.py in the reference, with JAX-stack deps)."""

from setuptools import find_packages, setup

setup(
    name="unet-zoo-tpu",
    version="0.1.0",
    description=(
        "TPU-native JAX/Flax model zoo of U-Net variants for 2D medical "
        "image segmentation, with a YAML-config training harness"
    ),
    author="unet-zoo-tpu contributors",
    packages=find_packages(include=["unet_zoo_tpu", "unet_zoo_tpu.*",
                                    "unet_zoo_tpu_torch", "unet_zoo_tpu_torch.*"]),
    # the native decode pipeline ships as source and builds lazily with
    # the system g++ on first use (unet_zoo_tpu/native/__init__.py); the
    # port's CUDA kernels likewise build with nvcc on first launch
    package_data={"unet_zoo_tpu.native": ["io_native.cpp"],
                  "unet_zoo_tpu_torch.ops.kernels": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "optax",
        "orbax-checkpoint",
        "numpy",
        "Pillow",
        "matplotlib",
        "pyyaml",
        "einops",
    ],
    extras_require={
        "tests": ["pytest", "torch"],
        "tb": ["tensorboard"],
    },
)
