"""Command-line probes of single kernels on the card, counterparts of the
JAX package's root probes (``_probe_int8_mosaic.py``, ``_probe_gather.py``)."""
