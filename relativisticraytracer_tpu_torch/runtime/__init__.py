"""runtime (PyTorch port): the host runtime — session, animation jobs, frame sink, preview, profiling."""
