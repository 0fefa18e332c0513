"""Stream formats of the PyTorch port: its self-describing header
(``metadata.py``) and the reference libraries' formats (``ref_stream.py``,
``cpu_stream.py``, ``mdrx_stream.py``)."""
