"""Embedding model and tokenizers of the PyTorch port."""
