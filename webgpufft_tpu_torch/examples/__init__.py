"""Applications of the PyTorch port, ported from the repository's
``examples/``."""
