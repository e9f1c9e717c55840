"""The benchmark of the PyTorch and CUDA port (``semtools_tpu_torch``):
see ``run.py``."""
