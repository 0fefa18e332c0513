"""Lossless stage of the PyTorch port: the BFP and BFX codecs, the section
framing (``registry.py``) and the host byte codecs (``host.py``,
``lz4.py``)."""
