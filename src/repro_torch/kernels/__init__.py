"""kernels of the PyTorch port."""
