"""The benchmark of the PyTorch port (see README.md)."""
