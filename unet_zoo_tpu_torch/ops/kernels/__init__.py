"""Hand-written Hopper kernels (``csrc/``) and their plain PyTorch versions.

Modules here import no compiler or GPU package at import time; each kernel
is built on its first launch (``build.py``).
"""
