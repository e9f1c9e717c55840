"""Probes of the scan on the card: what device memory and each unit give a
phase-1 sweep. One module per probe of the JAX package, each run as
``python -m semtools_tpu_torch.probes.<name>`` (``--device cpu --rows N``
runs the plain versions at a small size and measures nothing)."""
