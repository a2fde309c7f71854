"""Text codecs of the port: byte-level BPE (``bpe.py``) and its bundled data
(``data/``)."""
