"""Lossless stage of the PyTorch port: the BFP codec and the section
framing (``registry.py``)."""
