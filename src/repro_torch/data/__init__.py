"""Data: the deterministic synthetic LM stream (``pipeline``)."""
