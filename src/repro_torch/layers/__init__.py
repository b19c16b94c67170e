"""layers of the PyTorch port (mirrors repro.layers)."""
