"""Losses and the fused loss kernels of the PyTorch port."""
