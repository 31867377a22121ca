"""render (PyTorch port)."""
