"""launch of the PyTorch port."""
