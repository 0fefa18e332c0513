"""Array operators of the PyTorch port."""
