"""Host utilities of the PyTorch port (device choice, tracing)."""
