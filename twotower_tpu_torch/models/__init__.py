"""Two-tower model of the PyTorch port."""
