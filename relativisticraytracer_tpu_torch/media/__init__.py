"""media (PyTorch port)."""
