"""tools (PyTorch port): measurement probes run on the card."""
