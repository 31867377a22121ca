"""physics (PyTorch port)."""
