"""Device ops of the PyTorch port: embed, scan, and the fused scan kernels."""
