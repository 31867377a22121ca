"""io (PyTorch port): PNG stills and frame sequences, video recording."""
