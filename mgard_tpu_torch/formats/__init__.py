"""Stream formats of the PyTorch port (the self-describing header)."""
