"""Core runtime of the PyTorch port."""
