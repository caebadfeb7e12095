"""Command-line entry points: ``python -m unet_zoo_tpu_torch.cli.train`` and
``python -m unet_zoo_tpu_torch.cli.evaluate``."""
