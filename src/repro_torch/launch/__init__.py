"""Command-line drivers of the PyTorch port (``python -m
repro_torch.launch.evolve``)."""
